"""Experiment runner of the port: ``python -m tosem_tpu_torch.cli``.

Counterpart of ``tosem_tpu/cli.py`` (``python -m tosem_tpu.cli``): each
config writes its measurements as rows of the study's CSV schema
(:mod:`tosem_tpu_torch.utils.results`), so both packages' files join on
``bench_id``. Every north-star config runs:

``--config=gemm`` (config 1, ``ops/gemm.py`` on cuBLAS: the JAX
package's sweep on the card, 256^3 fp32 on the CPU) and
``--config=timing_check`` (graph replay against the differential batch
method on the same GEMMs: 8192^3 and 1024^3 bf16, 1024^3 fp32 on the
card). ``--config=conv_sweep`` (config 2, ``ops/conv.py`` on cuDNN: the
ResNet-50 layer shapes at batch 32, fp32 and bf16, ``--dtype`` picks one;
one 3x3 shape on the CPU). ``--config=resnet_train`` (config 4:
ResNet-50 on CIFAR-shaped synthetic data, batch 256 on the card and 16
on the CPU, SGD with momentum 0.9, ``--steps`` timed steps after 3
warm-up steps, ``--converge_steps``/``--target_acc`` the convergence
gate). ``--config=bert_train``: BERT masked-LM steps with flash
attention against dense attention on one set of weights and one batch
(BERT-base 8 x 512 on the card, tiny 2 x 64 on the CPU; ``--remat``).
With ``--profile`` either train config writes the kernel summary of 3
traced steps (``profiler/trace.py``).
``--config=kernel_matrix`` runs the cross-backend kernel bench
(``ops/bench_kernels.py``), and the ``microbench`` subcommand
``runtime/bench_runtime.py``'s suites (``--kernels``, ``--sparse`` and
the rest). The ``chaos`` subcommand (``chaos/cli.py``) runs a fault plan
against its workload and prints the survival report (``chaos --list``,
``chaos --plan decode-chaos [--device=cpu]``).

``bert_kernels`` is north-star config 5::

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

``--config=speech_train`` runs the DeepSpeech-family leg end to end:
the synthetic WAV corpus (16 utterances on the card, 6 on the CPU;
``--speech_data=ldc93s1`` the LDC93S1 import, fabricated when its files
are absent, or a CSV manifest or SDB bundle path), MFCC featurized in
length buckets, CTC training of the CLI's small acoustic model (26 MFCC,
context 2, 96 hidden, 96 cells, Adam 3e-3) for ``--steps`` epochs (6x
that on the card), then WER with greedy, beam and LM-scored beam decode
(a scorer built from the corpus' transcripts): rows ``speech_ctc_loss``
and ``speech_wer_{greedy,beam,beam_lm}``.

``--config=detection_train`` trains the tiny EfficientDet on two
synthetic images with one box each (Adam 2e-3, fp32; ``--steps`` steps,
6x on the card) and reports COCO-style AP50 and AP;
``--config=detection_infer`` times its forward and host postprocess and
exports the forward with ``torch.export`` (``compile/export.py``);
``--config=pointpillars_infer`` times PointPillars' ``apply`` and
``detect`` (the NMS sweep, ``ops/csrc/nms.cu`` on the card) at a
141 x 141 grid and 16,384 points on the card, 4 x 4 and 256 on the CPU.

``--config=analysis`` runs the study's analysis layer
(``analysis/study.py``): it classifies the test suite under
``--tests_dir`` into the RQ3/RQ4 tables and correlates the results CSVs
(``results/*.csv`` and those beside ``--results_csv``, its own rows left
out) into ``--analysis_out``. Its replication leg runs only where
``--reference_dir`` holds the study checkout's ``src/``; elsewhere it is
skipped and says so. The rows run on the host, whatever ``--device``.

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
    "flash_autotune": "A4 (the flash half of block selection)",
}


def _row_device(device) -> str:
    return "gpu" if device.type == "cuda" else "cpu"


def _sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def run_gemm(args, device) -> List[Any]:
    from tosem_tpu_torch.ops.gemm import (DEFAULT_GEMM_SWEEP, GemmSpec,
                                          gemm_bench)
    sweep = DEFAULT_GEMM_SWEEP
    if device.type == "cpu":      # the north-star shape only, small
        sweep = [GemmSpec(256, 256, 256, "float32", "float32")]
    rows = []
    for spec in sweep:
        _, row = gemm_bench(spec, device=device)
        rows.append(row)
        print(f"  {row.bench_id}: {row.value:.1f} {row.unit}")
    return rows


def run_timing_check(args, device) -> List[Any]:
    """The two timing harnesses against each other on the same GEMM
    operands: graph replay (``DeviceLoopBench``, one replay of N
    captured calls) and the differential batch method (``time_fn``: N
    calls launched from Python, one sync). They share no mechanism, so a
    reading that is a timing artifact makes them disagree. Where one
    call's host launch outlasts its kernel (1024^3 bf16 on the card),
    the batch method times the launch rate and the ratio says so. One
    row a (shape, method) and an agreement row (loop / batch)."""
    from tosem_tpu_torch.ops.gemm import (GemmSpec, gemm, gemm_bench,
                                          gemm_operands, timing_kind)
    from tosem_tpu_torch.utils.results import ResultRow
    from tosem_tpu_torch.utils.timing import gflops, time_fn
    shapes = ([GemmSpec(8192, 8192, 8192, "bfloat16", "default"),
               GemmSpec(1024, 1024, 1024, "bfloat16", "default"),
               GemmSpec(1024, 1024, 1024, "float32", "float32")]
              if device.type == "cuda" else
              [GemmSpec(256, 256, 256, "float32", "float32")])
    dev = _row_device(device)
    rows = []
    for spec in shapes:
        _, loop = gemm_bench(spec, device=device)
        loop_row = ResultRow(project="ops", config="timing_check",
                             bench_id=f"{spec.bench_id}_deviceloop",
                             metric="gflops", value=loop.value,
                             unit="GFLOPS", device=dev, n_devices=1,
                             extra=dict(loop.extra))
        a, b = gemm_operands(spec, device=device)
        prec = spec.precision
        stats = time_fn(lambda: gemm(a, b, prec), iters=8, name="batch")
        batch_gf = gflops(spec.flops, stats.min_s)
        rows.append(loop_row)
        rows.append(ResultRow(
            project="ops", config="timing_check",
            bench_id=f"{spec.bench_id}_batch", metric="gflops",
            value=batch_gf, unit="GFLOPS", device=dev, n_devices=1,
            extra={"m": spec.m, "n": spec.n, "k": spec.k,
                   "dtype": spec.dtype, "precision": spec.precision,
                   "mean_ms": stats.mean_ms, "min_ms": stats.min_s * 1e3,
                   "timing": "host_batch"}))
        rows.append(ResultRow(
            project="ops", config="timing_check",
            bench_id=f"{spec.bench_id}_agreement", metric="ratio",
            value=loop_row.value / batch_gf if batch_gf else -1.0,
            unit="x", device=dev, n_devices=1,
            extra={"loop_gflops": round(loop_row.value, 1),
                   "batch_gflops": round(batch_gf, 1),
                   "loop_timing": timing_kind(device)}))
    for r in rows:
        print(f"  {r.bench_id}: {r.value:.1f} {r.unit}")
    return rows


def run_conv_sweep(args, device) -> List[Any]:
    """Config 2: both ResNet-50 sweeps on the card (``--dtype`` keeps
    one), one 3x3 shape on the CPU. The JAX package's CPU shape builds
    its ``ConvSpec`` without a name and raises (ROADMAP.md C-ref15);
    the port names it ``cpu_3x3``."""
    from tosem_tpu_torch.ops.conv import (RESNET50_CONV_SWEEP,
                                          RESNET50_CONV_SWEEP_BF16,
                                          ConvSpec, conv_bench)
    if device.type == "cpu":
        sweep = [ConvSpec("cpu_3x3", batch=2, h=28, w=28, c_in=32,
                          c_out=32, kh=3, kw=3, stride=1, dtype="float32",
                          precision="float32")]
    elif args.dtype == "float32":
        sweep = list(RESNET50_CONV_SWEEP)
    elif args.dtype == "bfloat16":
        sweep = list(RESNET50_CONV_SWEEP_BF16)
    else:
        sweep = list(RESNET50_CONV_SWEEP) + list(RESNET50_CONV_SWEEP_BF16)
    rows = []
    for spec in sweep:
        _, row = conv_bench(spec, device=device)
        rows.append(row)
        print(f"  {row.bench_id}: {row.value:.1f} {row.unit}")
    return rows


def _resnet_batch(b, device):
    import torch
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _profile_steps(args, name, device, run_steps) -> None:
    """Trace ``run_steps()`` (3 train steps) and write their kernel
    summary to ``<results dir>/profile/<name>/kernel_summary.csv``."""
    import os

    from tosem_tpu_torch.profiler.trace import (capture_trace,
                                                kernel_summary_csv)
    prof_dir = os.path.join(os.path.dirname(args.results_csv) or ".",
                            "profile", name)
    with capture_trace(prof_dir):
        run_steps()
        _sync(device)
    csv_path = os.path.join(prof_dir, "kernel_summary.csv")
    stats = kernel_summary_csv(prof_dir, csv_path)
    print(f"  profile: {len(stats)} kernels -> {csv_path}")


def run_resnet_train(args, device) -> List[Any]:
    """Config 4: ResNet-50 (bf16, CIFAR's 3x3 stem, 10 classes, weights
    from seed 0) trained by SGD with momentum 0.9 on
    ``cifar_like_batches``: 3 warm-up steps, then ``--steps`` steps
    timed as one block (one sync at its end). Rows ``step_time_ms`` and
    ``images_per_sec``; ``--profile`` traces 3 more steps (the last
    3 batches again) and writes their kernel summary under
    ``<results dir>/profile/``; with ``--converge_steps`` more steps
    and the held-out accuracy gate."""
    import numpy as np
    import torch
    from tosem_tpu_torch.data.synthetic import cifar_like_batches
    from tosem_tpu_torch.models.resnet import resnet50
    from tosem_tpu_torch.train.trainer import (classification_loss,
                                               create_train_state,
                                               make_train_step)
    from tosem_tpu_torch.utils.results import ResultRow
    batch = args.batch or (256 if device.type == "cuda" else 16)
    steps = max(args.steps, 1)
    model = resnet50(num_classes=10, small_inputs=True, device=device)
    st = create_train_state(model, lambda p: torch.optim.SGD(
        p, lr=args.lr, momentum=0.9))
    step = make_train_step(model, st.optimizer, classification_loss)
    batches = [_resnet_batch(b, device)
               for b in cifar_like_batches(batch, steps=steps + 3)]
    warmup = 3
    for b in batches[:warmup]:
        st, metrics = step(st, b)
    _sync(device)
    t0 = time.perf_counter()
    for b in batches[warmup:]:
        st, metrics = step(st, b)
    loss = float(metrics["loss"])          # the block's one sync
    step_s = (time.perf_counter() - t0) / steps
    dev = _row_device(device)
    rows = [
        ResultRow(project="train", config="resnet_train",
                  bench_id=f"resnet50_cifar_b{batch}", metric="step_time_ms",
                  value=step_s * 1e3, unit="ms", device=dev, n_devices=1,
                  extra={"batch": batch, "steps": steps,
                         "final_loss": loss, "dtype": "bfloat16"}),
        ResultRow(project="train", config="resnet_train",
                  bench_id=f"resnet50_cifar_b{batch}",
                  metric="images_per_sec", value=batch / step_s,
                  unit="img/s", device=dev, n_devices=1,
                  extra={"batch": batch}),
    ]
    if args.profile:
        def traced():
            nonlocal st
            for b in batches[-3:]:
                st, _ = step(st, b)
        _profile_steps(args, f"resnet_train_{_row_device(device)}",
                       device, traced)
    if args.converge_steps > 0:
        from tosem_tpu_torch.data.synthetic import SyntheticImageDataset
        for b in cifar_like_batches(batch, steps=args.converge_steps):
            st, metrics = step(st, _resnet_batch(b, device))
        final_loss = float(metrics["loss"])
        xv, yv = SyntheticImageDataset().materialize_val(256)
        with torch.no_grad():
            logits = model(torch.from_numpy(xv).to(device), train=False)
        acc = float(np.mean(logits.argmax(-1).cpu().numpy() == yv))
        passed = acc >= args.target_acc and final_loss < 1.0
        rows.append(ResultRow(
            project="train", config="resnet_train",
            bench_id=f"resnet50_convergence_b{batch}", metric="val_acc",
            value=acc, unit="ratio", device=dev, n_devices=1,
            extra={"converge_steps": args.converge_steps,
                   "final_loss": final_loss,
                   "target_acc": args.target_acc, "passed": bool(passed)}))
        print(f"  convergence gate: val_acc={acc:.3f} loss={final_loss:.3f}"
              f" -> {'PASS' if passed else 'FAIL'}")
    for r in rows:
        print(f"  {r.bench_id}: {r.value:.2f} {r.unit}")
    return rows


def run_bert_train(args, device) -> List[Any]:
    """BERT masked-LM train steps, flash attention against dense
    attention on the same weights (seed 0) and batch (random ids from
    numpy seed 1, labels = ids, 15% masked), each from a fresh
    ``adamw(1e-4)``: 2 warm-up steps, then ``--steps`` steps timed as
    one block; step ``i`` draws dropout from ``step_generator(2, i)``.
    Rows ``step_time_ms`` and ``train_gflops`` an arm (the JAX package's
    FLOP count, 6 N B T + 3 * 12 L B T^2 dim) and the ``flash_vs_xla``
    speedup; the dense arm keeps the JAX package's name ``xla`` so both
    packages' rows join. ``extra["losses"]`` holds every timed step's
    loss. ``--profile`` traces 3 more flash steps (one untraced first)
    and writes their kernel summary under ``<results dir>/profile/``."""
    import dataclasses
    import functools

    import numpy as np
    import torch
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    from tosem_tpu_torch.train.trainer import (adamw, create_train_state,
                                               make_train_step, mlm_loss,
                                               step_generator)
    from tosem_tpu_torch.utils.results import ResultRow
    on_card = device.type == "cuda"
    cfg = BertConfig.base() if on_card else BertConfig.tiny()
    if args.remat not in ("none", "full", "dots"):
        raise ValueError(f"--remat must be none|full|dots, got "
                         f"{args.remat!r}")
    if args.remat != "none":
        cfg = dataclasses.replace(cfg, remat=args.remat)
    B = args.batch or (8 if on_card else 2)
    T = min(args.seq or (512 if on_card else 64), cfg.max_len)
    steps = max(args.steps, 1)
    model = Bert(cfg, device=device, seed=0)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(1)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                          device=device)
    masked = torch.as_tensor(rng.random((B, T)) < 0.15, device=device)
    batch = {"ids": ids, "labels": ids, "masked": masked}
    n_params = sum(p.numel() for p in model.parameters())
    attn_flops = 12 * cfg.layers * B * T * T * cfg.dim
    flops_per_step = 6 * n_params * B * T + 3 * attn_flops

    def fresh(attn_fn):
        model.load_state_dict(init)
        st = create_train_state(model, adamw(1e-4))
        return st, make_train_step(model, st.optimizer, functools.partial(
            mlm_loss, attn_fn=attn_fn))

    size = "base" if on_card else "tiny"
    tag = "" if cfg.remat == "none" else f"_remat-{cfg.remat}"
    dev = _row_device(device)
    rows, times = [], {}
    for name, afn in (("xla", None), ("flash", flash_attn_fn())):
        st, step = fresh(afn)
        for i in range(2):
            st, met = step(st, batch, step_generator(2, i, device))
        _sync(device)
        losses = []
        t0 = time.perf_counter()
        for i in range(2, 2 + steps):
            st, met = step(st, batch, step_generator(2, i, device))
            losses.append(met["loss"])
        losses = [float(x) for x in losses]      # the block's one sync
        step_s = (time.perf_counter() - t0) / steps
        times[name] = step_s
        bench_id = f"bert_{size}_b{B}_t{T}_{name}{tag}"
        rows.append(ResultRow(
            project="train", config="bert_train", bench_id=bench_id,
            metric="step_time_ms", value=step_s * 1e3, unit="ms",
            device=dev, n_devices=1,
            extra={"batch": B, "seq": T, "attn": name,
                   "final_loss": losses[-1], "losses": losses,
                   "params": n_params, "dtype": cfg.dtype,
                   "remat": cfg.remat}))
        rows.append(ResultRow(
            project="train", config="bert_train", bench_id=bench_id,
            metric="train_gflops", value=flops_per_step / step_s / 1e9,
            unit="GFLOPS", device=dev, n_devices=1,
            extra={"batch": B, "seq": T, "attn": name, "dtype": cfg.dtype,
                   "remat": cfg.remat, "flops_per_step": flops_per_step}))
        del st, step
    rows.append(ResultRow(
        project="train", config="bert_train",
        bench_id=f"bert_b{B}_t{T}_flash_vs_xla{tag}", metric="speedup",
        value=times["xla"] / times["flash"], unit="x", device=dev,
        n_devices=1, extra={"xla_ms": times["xla"] * 1e3,
                            "flash_ms": times["flash"] * 1e3}))
    if args.profile:
        st, step = fresh(flash_attn_fn())
        st, _ = step(st, batch, step_generator(3, 0, device))
        _sync(device)

        def traced():
            nonlocal st
            for i in range(1, 4):
                st, _ = step(st, batch, step_generator(3, i, device))
        _profile_steps(args, f"bert_train_{_row_device(device)}{tag}",
                       device, traced)
        del st, step
    for r in rows:
        print(f"  {r.bench_id} {r.metric}: {r.value:.2f} {r.unit}")
    return rows


def run_speech_train(args, device) -> List[Any]:
    """The DeepSpeech train + ``evaluate.py`` roles, hermetic through the
    importer's fabricated WAVs (the JAX package's ``speech_train``):
    bucketed batches of 4, Adam 3e-3 on the mean CTC loss, then one
    padded batch of every utterance decoded greedy, by beam search and
    by beam search with an order-2 scorer of the transcripts."""
    import functools
    import tempfile

    import numpy as np
    import torch
    from tosem_tpu_torch.data.audio import labels_to_text
    from tosem_tpu_torch.data.feeding import (import_synthetic_corpus,
                                              speech_batches)
    from tosem_tpu_torch.data.sample_collections import (import_ldc93s1,
                                                         open_collection)
    from tosem_tpu_torch.data.scorer import build_scorer
    from tosem_tpu_torch.models.speech import (SpeechConfig, SpeechModel,
                                               evaluate_wer, wer)
    from tosem_tpu_torch.ops.ctc import Scorer, ctc_loss_mean, greedy_decode
    from tosem_tpu_torch.train.trainer import (create_train_state,
                                               make_train_step)
    from tosem_tpu_torch.utils.results import ResultRow
    on_card = device.type == "cuda"

    def as_batch(b):
        return {k: torch.from_numpy(getattr(b, k)).to(device)
                for k in ("features", "labels", "feature_lengths",
                          "label_lengths")}

    with tempfile.TemporaryDirectory(prefix="tosem_torch_speech_") as tmp:
        if args.speech_data == "ldc93s1":
            manifest = import_ldc93s1(tmp, fabricate=True)
        elif args.speech_data:
            manifest = args.speech_data
        else:
            manifest = import_synthetic_corpus(tmp, n=16 if on_card else 6,
                                               seed=0)
        refs = [s.transcript for s in open_collection(manifest)]
        n_utts = len(refs)
        if not refs:
            raise ValueError(f"no samples in speech data {manifest!r}")
        # label capacity fits the longest transcript
        max_label = max(24, max(len(r) for r in refs) + 1)
        cfg = SpeechConfig(n_input=26, n_context=2, n_hidden=96, n_cell=96,
                           vocab_size=28, dropout=0.0)
        model = SpeechModel(cfg, device=device, seed=0)

        def loss_fn(m, batch, generator=None):
            logits, _ = m(batch["features"])
            return ctc_loss_mean(logits, batch["labels"],
                                 batch["feature_lengths"],
                                 batch["label_lengths"],
                                 blank=cfg.blank), {}

        st = create_train_state(model, functools.partial(
            torch.optim.Adam, lr=3e-3, betas=(0.9, 0.999), eps=1e-8))
        step = make_train_step(model, st.optimizer, loss_fn)
        batches = [as_batch(b) for b in speech_batches(
            manifest, batch_size=4, n_buckets=2, max_label_len=max_label,
            device=device)]
        epochs = max(args.steps, 1) * (6 if on_card else 1)
        losses = []
        for _ in range(epochs):
            for b in batches:
                st, met = step(st, b)
                losses.append(met["loss"])
        losses = [float(x) for x in losses]
        first_loss, last_loss = losses[0], losses[-1]

        # eval: one padded batch of every utterance, three decode modes
        batch = next(speech_batches(manifest, batch_size=n_utts,
                                    n_buckets=1, max_label_len=max_label,
                                    sort_by_size=False, device=device))
        with torch.no_grad():
            logits, _ = model(torch.from_numpy(batch.features).to(device))
        logp = torch.log_softmax(logits.float(), -1).cpu().numpy()
        lengths = batch.feature_lengths
        ref_texts = [labels_to_text(
            [int(x) for x in batch.labels[i][:int(batch.label_lengths[i])]])
            for i in range(n_utts)]
        scorer_path = f"{tmp}/corpus.scorer"
        build_scorer(refs, scorer_path, order=2)
        scorer = Scorer(scorer_path, alpha=1.0, beta=0.3)
        beam = evaluate_wer(logp, lengths, ref_texts, blank=cfg.blank,
                            beam_width=16)
        beam_lm = evaluate_wer(logp, lengths, ref_texts, blank=cfg.blank,
                               beam_width=16, scorer=scorer)
        scorer.close()
        dec, n_dec = greedy_decode(logits, torch.from_numpy(lengths),
                                   blank=cfg.blank)
        dec, n_dec = dec.cpu().numpy(), n_dec.cpu().numpy()
        greedy = float(np.mean([
            wer(ref_texts[i], labels_to_text(
                [int(x) for x in dec[i][:int(n_dec[i])]]))
            for i in range(n_utts)]))

    dev = _row_device(device)
    rows = [ResultRow(project="models", config="speech_train",
                      bench_id="speech_ctc_loss", metric="ctc_loss",
                      value=last_loss, unit="nats", device=dev,
                      extra={"first_loss": first_loss, "epochs": epochs,
                             "n_utts": n_utts, "steps": len(losses)})]
    for mode, val in [("greedy", greedy), ("beam", beam["wer"]),
                      ("beam_lm", beam_lm["wer"])]:
        rows.append(ResultRow(
            project="models", config="speech_train",
            bench_id=f"speech_wer_{mode}", metric="wer",
            value=float(val), unit="ratio", device=dev,
            extra={"decoder": mode, "n_utts": n_utts}))
    for r in rows:
        print(f"  {r.bench_id}: {r.value:.4f} {r.unit}")
    return rows


def run_analysis(args, device) -> List[Any]:
    """Study analysis layer (L8): classify the test suite into the
    RQ3/RQ4 taxonomy and correlate the bench CSVs — the consumer role of
    ``RQs/RQ3/tests_correlate_rq3.csv`` / ``RQs/RQ4/tests_methods_v3.csv``.
    The JAX package's ``run_analysis``; with no study checkout at
    ``--reference_dir`` it prints that the replication leg is skipped."""
    import glob
    import os

    from tosem_tpu_torch.analysis import run_study
    from tosem_tpu_torch.utils.results import ResultRow

    out_dir = args.analysis_out
    # scan both the default results dir and wherever this run is writing;
    # rows with config=="analysis" are filtered at load so the analysis
    # never re-ingests its own output
    bench_csvs = sorted(set(glob.glob("results/*.csv"))
                        | set(glob.glob(os.path.join(
                            os.path.dirname(args.results_csv) or ".",
                            "*.csv"))))
    summary = run_study(args.tests_dir, bench_csvs, out_dir)
    rows = [ResultRow(project="analysis", config="analysis",
                      bench_id=f"tests_{m}", metric="test_count",
                      value=float(n), unit="tests", device="host",
                      extra={"out_dir": out_dir})
            for m, n in sorted(summary["by_method"].items())]
    rows.append(ResultRow(
        project="analysis", config="analysis",
        bench_id="tests_with_strategy", metric="pct",
        value=float(summary["with_strategy_pct"]), unit="%", device="host",
        extra={"n_tests": summary["n_tests"],
               "n_strategies": summary["n_strategies"],
               "n_projects": summary["n_projects"],
               "bench_correlations": summary["bench_correlations"]}))
    # replication leg: when the study checkout is mounted, also score
    # the classifier against the published per-repo strategy tables
    ref = args.reference_dir
    if ref and os.path.isdir(os.path.join(ref, "src")):
        from tosem_tpu_torch.analysis.replicate import run_replication
        try:
            rep = run_replication(ref, out_dir)
        except FileNotFoundError as e:
            # a PARTIAL study mount: drop the replication leg only,
            # never the RQ3/RQ4 rows computed above
            print(f"  replication leg skipped: {e}")
            rep = {}
        for a in rep.get("strategy_agreement", []):
            rows.append(ResultRow(
                project="analysis", config="analysis",
                bench_id=f"replication_{a['project']}",
                metric="spearman", value=float(a["spearman"]),
                unit="rank-corr", device="host",
                extra={"top_overlap": a["top_overlap"],
                       "top_k": a["top_k"],
                       "n_shared": a["n_shared_strategies"]}))
    else:
        print(f"  replication leg skipped: no study checkout at "
              f"--reference_dir={ref!r}")
    for r in rows:
        print(f"  {r.bench_id}: {r.value:g} {r.unit}")
    print(f"  tables -> {out_dir}/")
    return rows


def run_kernel_matrix(args, device) -> List[Any]:
    """The cross-backend kernel bench (``ops/bench_kernels.py``) as a
    config: on the card the ``cuda`` arm (graph replay) and the
    ``torch`` arm on CPU copies (host rate), pinned against each other
    first; on the CPU the ``torch`` arm, pinned to the oracles. Rows
    carry ``extra.platform``, ``extra.timing`` and ``extra.on_chip``."""
    from tosem_tpu_torch.ops.bench_kernels import run_kernel_benchmarks
    return _tagged(run_kernel_benchmarks(trials=2, min_s=0.4,
                                         platform=device.type),
                   "kernel_matrix")


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


# calls in one timing of a collective on the card. Capturing a shard_map
# call costs the host about 4 ms (its position threads meet), so windows
# calibrated to 20 ms (up to 4096 calls of a 5 us collective) captured
# 70735 calls over the sweep, about 290 s; 256 calls of the shortest
# row still last over a millisecond of device time against a graph
# launch of about 10 us.
ALLREDUCE_CALLS = 256


def run_allreduce(args, device) -> List[Any]:
    """North-star config 3: the six collectives over a 1-D mesh of
    positions (8 on the CPU, as the JAX package's tests have 8 virtual
    devices; 4 a card on cuda, spread over the cards in turn), 1 KB to
    256 MB a position (``--max_bytes`` caps it; 4 MB on the CPU;
    ``--sweep_every`` thins the ladder of sizes). On cuda each timing is
    one graph of :data:`ALLREDUCE_CALLS` calls; the CPU takes one call a
    timing."""
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
    if args.sweep_every < 1:
        raise ValueError(f"--sweep_every must be at least 1, got "
                         f"{args.sweep_every}")
    sizes = sorted({s.bytes_per_device for s in DEFAULT_COLLECTIVE_SWEEP})
    keep = set(sizes[::args.sweep_every])
    rows = []
    for spec in DEFAULT_COLLECTIVE_SWEEP:
        if (cap and spec.bytes_per_device > cap
                or spec.bytes_per_device not in keep):
            continue
        row = collective_bench(
            spec, mesh,
            n_iter=1 if device.type == "cpu" else ALLREDUCE_CALLS,
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


def _detection_setup(device, batch):
    """The JAX package's detection recipe: ``EfficientDetConfig.tiny()``,
    weights from seed 0, ``batch`` images drawn from numpy seed 0, their
    anchors."""
    import numpy as np
    import torch
    from tosem_tpu_torch.models.efficientdet import (EfficientDet,
                                                     EfficientDetConfig,
                                                     generate_anchors)
    cfg = EfficientDetConfig.tiny()
    model = EfficientDet(cfg, device=device, seed=0)
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(batch, cfg.image_size, cfg.image_size, 3)).astype(
            np.float32)).to(device)
    return cfg, model, imgs, generate_anchors(cfg)


def run_detection_train(args, device) -> List[Any]:
    """EfficientDet training on synthetic boxes, then COCO-style AP (the
    ``efficientdet/main.py`` train and ``coco_metric.py`` eval roles):
    tiny EfficientDet, 2 images with one box each, Adam 2e-3 in fp32
    (TF32 off); one untimed step, then ``--steps`` steps (6x on the card)
    timed as one block; detections above score 0.1 through the host NMS.
    Rows ``ap50`` (``extra.ap``, the steps, the first and final loss) and
    ``step_time_ms``."""
    import numpy as np
    import torch
    from tosem_tpu_torch.models.detection_eval import evaluate_detections
    from tosem_tpu_torch.models.efficientdet import (detection_loss,
                                                     postprocess)
    from tosem_tpu_torch.ops.common import precision
    from tosem_tpu_torch.utils.results import ResultRow
    B = 2
    cfg, model, imgs, anchors = _detection_setup(device, B)
    steps = max(args.steps, 1) * (6 if device.type == "cuda" else 1)
    s = cfg.image_size
    boxes = [[[0.2 * s, 0.25 * s, 0.7 * s, 0.8 * s]]] * B
    classes = [[2]] * B
    gt_boxes = torch.tensor(boxes, dtype=torch.float32, device=device)
    gt_classes = torch.tensor(classes, device=device)
    n_gt = torch.ones(B, dtype=torch.int32, device=device)
    anchors_t = torch.from_numpy(anchors).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=2e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        cl, bx = model(imgs, train=True)
        loss = detection_loss(cl, bx, gt_boxes, gt_classes, n_gt,
                              anchors_t, cfg)["loss"]
        loss.backward()
        opt.step()
        return loss.detach()

    with precision("float32"):
        first = float(step())           # untimed: the first step's set-up
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step()
        loss = float(loss)              # the block's one sync
        step_ms = (time.perf_counter() - t0) / steps * 1e3
        with torch.no_grad():
            cl, bx = model(imgs, train=False)
    dets = postprocess(cl, bx, anchors, score_thresh=0.1)
    ap = evaluate_detections(
        [{"boxes": d[0], "scores": d[1], "classes": d[2]} for d in dets],
        [{"boxes": np.asarray(b), "classes": np.asarray(c)}
         for b, c in zip(boxes, classes)])
    dev = _row_device(device)
    rows = [
        ResultRow(project="models", config="detection_train",
                  bench_id=f"efficientdet_tiny_b{B}", metric="ap50",
                  value=ap["AP50"], unit="AP", device=dev, n_devices=1,
                  extra={"ap": ap["AP"], "steps": steps,
                         "first_loss": first, "final_loss": loss}),
        ResultRow(project="models", config="detection_train",
                  bench_id=f"efficientdet_tiny_b{B}", metric="step_time_ms",
                  value=step_ms, unit="ms", device=dev, n_devices=1,
                  extra={"batch": B}),
    ]
    for r in rows:
        print(f"  {r.bench_id}: {r.metric}={r.value:.3f} {r.unit}")
    return rows


def run_detection_infer(args, device) -> List[Any]:
    """EfficientDet inference latency and export (the ``model_inspect.py``
    bm and export run modes): the tiny model's eval forward timed by
    ``DeviceLoopBench`` (graph replay on the card), the host
    postprocess (decode and NMS) per image, and the forward exported by
    ``compile/export.py`` (``torch.export``: ``.pt2`` and ``.meta``)
    under ``<results dir>/export/``. Rows ``latency_ms``,
    ``postprocess_ms`` and ``export_kb`` (KiB of the ``.pt2``; the JAX
    package's row is ``stablehlo_kb``)."""
    import os

    import torch
    from tosem_tpu_torch.compile.export import export_program
    from tosem_tpu_torch.models.efficientdet import postprocess
    from tosem_tpu_torch.ops.common import precision
    from tosem_tpu_torch.utils.results import ResultRow
    from tosem_tpu_torch.utils.timing import DeviceLoopBench
    B = max(args.batch, 1) if args.batch else 1
    cfg, model, imgs, anchors = _detection_setup(device, B)
    model.eval()

    def fwd(x):
        with torch.no_grad():
            return model(x, train=False)

    with precision("float32"):
        sec = DeviceLoopBench(op=fwd, args=(imgs,), perturb=0).time(reps=3)
        cls_logits, box_regs = fwd(imgs)
    t0 = time.perf_counter()
    for b in range(B):
        postprocess(cls_logits[b:b + 1], box_regs[b:b + 1], anchors)
    post_s = (time.perf_counter() - t0) / B
    export_dir = os.path.join(os.path.dirname(args.results_csv) or ".",
                              "export")
    paths = export_program(model, (imgs,), export_dir, "efficientdet_infer")
    dev = _row_device(device)
    rows = [
        ResultRow(project="models", config="detection_infer",
                  bench_id=f"effdet_tiny_fwd_b{B}", metric="latency_ms",
                  value=sec * 1e3, unit="ms", device=dev, n_devices=1,
                  extra={"image_size": cfg.image_size, "batch": B}),
        ResultRow(project="models", config="detection_infer",
                  bench_id=f"effdet_tiny_post_b{B}",
                  metric="postprocess_ms", value=post_s * 1e3, unit="ms",
                  device="cpu", n_devices=1, extra={"nms": "host"}),
        ResultRow(project="models", config="detection_infer",
                  bench_id="effdet_tiny_export", metric="export_kb",
                  value=os.path.getsize(paths["pt2"]) / 1024.0, unit="KiB",
                  device=dev, n_devices=1,
                  extra={"paths": sorted(paths.values()),
                         "format": "torch.export"}),
    ]
    for r in rows:
        print(f"  {r.bench_id}: {r.value:.2f} {r.unit}")
    return rows


def pointpillars_case(device):
    """The ``pointpillars_infer`` grid, points and detector: a 70.4 m x
    70.4 m field of 0.5 m pillars (141 x 141, 32 points each) and 16,384
    points on the card, a 4 x 4 grid of 8 and 256 points on the CPU;
    points uniform over the field (z in [-2, 2], intensity in [0, 1])
    from numpy seed 0, weights from seed 0."""
    import numpy as np
    import torch
    from tosem_tpu_torch.models.pointpillars import (PillarGrid,
                                                     PointPillarsDetector)
    on_card = device.type == "cuda"
    grid = (PillarGrid(0.0, 70.4, -35.2, 35.2, 141, 141, 32) if on_card
            else PillarGrid(0, 8, 0, 8, 4, 4, 8))
    n_pts = 16384 if on_card else 256
    det = PointPillarsDetector(grid, device=device, seed=0)
    lo = np.array([grid.x_min, grid.y_min, -2.0, 0.0], np.float32)
    hi = np.array([grid.x_max, grid.y_max, 2.0, 1.0], np.float32)
    pts = np.random.default_rng(0).uniform(lo, hi, (n_pts, 4)).astype(
        np.float32)
    return grid, det, torch.from_numpy(pts).to(device)


def run_pointpillars_infer(args, device) -> List[Any]:
    """PointPillars end to end (Apollo's lidar path): ``apply``
    (voxelize, PFN, canvas, head) and ``detect`` (with the NMS sweep)
    timed by ``DeviceLoopBench``, graph replay on the card. Rows
    ``latency_ms`` for each, with clouds a second."""
    import torch
    from tosem_tpu_torch.utils.results import ResultRow
    from tosem_tpu_torch.utils.timing import DeviceLoopBench
    grid, det, pts = pointpillars_case(device)
    n_pts = pts.shape[0]

    def apply_fn(p):
        with torch.no_grad():
            return det.apply(p)[0]

    def detect_fn(p):
        with torch.no_grad():
            boxes, scores, keep = det.detect(p)
        return boxes * keep[:, None].to(boxes.dtype) + scores[:, None]

    dev = _row_device(device)
    rows = []
    for name, fn, extra in (("apply", apply_fn, {}),
                            ("detect", detect_fn,
                             {"includes": "NMS sweep"})):
        sec = DeviceLoopBench(op=fn, args=(pts,), perturb=0).time()
        rows.append(ResultRow(
            project="models", config="pointpillars_infer",
            bench_id=f"pointpillars_{name}_n{n_pts}_{grid.nx}x{grid.ny}",
            metric="latency_ms", value=sec * 1e3, unit="ms", device=dev,
            n_devices=1,
            extra={"points": n_pts, "grid": [grid.nx, grid.ny], **extra,
                   "clouds_per_sec": round(1.0 / sec, 1)}))
    for r in rows:
        print(f"  {r.bench_id}: {r.value:.2f} {r.unit}")
    return rows


RUNNERS = {"gemm": run_gemm,
           "timing_check": run_timing_check,
           "conv_sweep": run_conv_sweep,
           "resnet_train": run_resnet_train,
           "bert_train": run_bert_train,
           "kernel_matrix": run_kernel_matrix,
           "bert_kernels": run_bert_kernels,
           "flash_sparse": run_flash_sparse,
           "allreduce": run_allreduce,
           "serve_bench": run_serve_bench,
           "autotune_decode_pages": run_autotune_decode_pages,
           "decode_bench": run_decode_bench,
           "decode_scenarios": run_decode_scenarios,
           "cluster_bench": run_cluster_bench,
           "control_bench": run_control_bench,
           "train_bench": run_train_bench,
           "speech_train": run_speech_train,
           "detection_train": run_detection_train,
           "detection_infer": run_detection_infer,
           "pointpillars_infer": run_pointpillars_infer,
           "analysis": run_analysis}


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
    ap.add_argument("--sweep_every", type=int, default=1,
                    help="allreduce: keep every n-th size of the sweep's "
                         "x4 ladder from 1 KB (2: 1 KB, 16 KB, 256 KB, ...)")
    ap.add_argument("--preset", choices=("tiny", "base"), default="tiny",
                    help="decode_bench/decode_scenarios: the decoder the "
                         "legs serve (the JAX package's tiny one, or "
                         "BERT-base)")
    ap.add_argument("--steps", type=int, default=20,
                    help="resnet_train/bert_train/detection_train: timed "
                         "steps (detection_train x6 on the card); "
                         "speech_train: epochs (x6 on the card)")
    ap.add_argument("--speech_data", default="",
                    help="speech_train data: '' = synthetic, 'ldc93s1' = "
                         "the LDC93S1 import path, else a CSV manifest or "
                         "SDB bundle path")
    ap.add_argument("--converge_steps", type=int, default=0,
                    help="resnet_train: extra steps for the convergence "
                         "gate (0 = throughput only)")
    ap.add_argument("--target_acc", type=float, default=0.6,
                    help="resnet_train: the gate's held-out accuracy")
    ap.add_argument("--lr", type=float, default=0.1,
                    help="resnet_train: SGD learning rate")
    ap.add_argument("--dtype", default="",
                    help="conv_sweep: float32 or bfloat16 alone")
    ap.add_argument("--profile", action="store_true",
                    help="bert_train, resnet_train: trace 3 steps and "
                         "write the kernel summary CSV")
    ap.add_argument("--remat", default="none",
                    help="bert_train activation remat: none|full|dots")
    ap.add_argument("--tests_dir", default="tests",
                    help="analysis: the test-suite directory")
    ap.add_argument("--analysis_out", default="results/torch_analysis",
                    help="analysis: output directory of the RQ tables "
                         "(the port's own: results/analysis holds the "
                         "JAX package's)")
    ap.add_argument("--reference_dir", default="",
                    help="analysis: the study checkout for the "
                         "replication leg (skipped when empty or "
                         "without a src/)")
    return ap


def main(argv: List[str] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "chaos":
        # `python -m tosem_tpu_torch.cli chaos --plan …` runs a fault plan
        # against its workload and prints a survival report
        # (tosem_tpu_torch/chaos/)
        from tosem_tpu_torch.chaos.cli import main as chaos_main
        return chaos_main(argv[1:])
    if argv and argv[0] == "microbench":
        # the ray-microbenchmark analog over the task and object planes,
        # and the kernel and sparse suites (--kernels, --sparse)
        from tosem_tpu_torch.runtime.bench_runtime import main as micro_main
        return micro_main(argv[1:])
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
