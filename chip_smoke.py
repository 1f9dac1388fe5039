#!/usr/bin/env python3
"""Drive the PyTorch port (``tosem_tpu_torch``) end to end on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it exits non-zero and prints no
result when either is missing or when the package is not beside it.

Phases, each printing one JSON line:

1. build    — nvcc builds every kernel source of ``tosem_tpu_torch/ops/csrc``
              (one process per source, started together); the bf16 B2/B3
              bodies at D = 16, 32 and 64 must hold HMMA, LDSM and LDGSTS
              in their SASS (``cuobjdump -sass``) and spill nothing
              (``ptxas -v``), and report the blocks an SM holds; every
              instantiation of B6's, B7's and B8's warp-row bodies must
              hold 16-byte global loads and stores (LDG.E.128,
              STG.E.128) and spill nothing, every instantiation of
              B4/B5's chunk body 16-byte global loads and no spill, and
              N1's three kernels spill nothing (registers and shared
              memory from ``ptxas -v``).
2. kernels  — each CUDA kernel against its plain PyTorch version on the
              card, at the main path's shapes, bf16 and fp32, with its
              time, its bound from bytes and operations, and a library
              yardstick where one PyTorch call computes the same
              function. Every kernel, library and whole-step time is
              device time (``utils/timing.DeviceLoopBench``: a CUDA graph
              of many calls over L2-cold operand copies); only the plain
              versions are timed by CUDA events around launches. B1 bf16
              also at its tensor-core body's edges (bhtd, Tq != Tk with a
              ragged Tk, rows whose segment has no key, D = 32 and 16; two
              launches bit for bit), and timed at the encode batch's
              shape, dense-segments and schedule mode, beside every SDPA
              backend that accepts the same call, in turns. The backward
              kernels (B2 dK/dV, B3 dQ) in both layouts, at a ragged
              length and at B1's edges, launched twice to show they are
              bit-deterministic, and timed beside SDPA's backward alone
              (the aten backward op of each fused backend, fed its own
              forward's outputs) and, as whole steps, the port's B1 +
              Delta + B2 + B3 beside SDPA's forward and backward. B4 at
              ragged lengths with an idle row, at page 128 and on a wide
              table (page 16, 32 slots), D = 16, 32, 64 and 128, launched
              twice and held equal to B5 at k = 1 bit for bit; B5 at k =
              1, 8 and 64, launched twice, its k = 8 row r equal to a B4
              step at seq_len - (k - 1 - r) bit for bit. B5's window and
              page-offset modes at windows 1, 100, 128 and 300 and k = 1,
              4 and 8 on rolling tables (page 128 at D = 16, 64 and 128,
              and page 16 at D = 64), bf16 and fp32: against the plain
              version, twice bit for bit, row r equal to a k = 1 launch
              at seq_len - (k - 1 - r) bit for bit, the rolling table
              within the tolerance of the full one, and the window
              dropped or the offsets zeroed each breaking the check;
              timed at bf16, page 128, k = 1, window 128. B6-B9
              (fused layernorm and softmax, forward and backward) at the
              kernel suite's shapes, a ragged row count, odd widths, a
              long row, the edges of the warp-row bodies (1024, 1025,
              1032 and 1 wide) and operands off 16 bytes, fp32 and bf16
              (layernorm with gamma in either dtype), B6, B7 and B8
              launched twice; each case names the body B6/B7/B8 ran, and
              the suite's shapes must run the warp-row one. B1-B3's schedule mode (``flash_*_sched``) under seven
              mask programs at [2, 1024, 12, 64], both layouts, fp32
              and bf16, with a PARTIAL-as-FULL yardstick, FullMask ==
              dense and CausalMask == causal bit for bit, B2/B3 launched
              twice; timed at the main paths' shapes beside SDPA with the
              same dense mask.
3. decode   — BERT-base greedy decode through ``BertDecodeBackend``'s
              client protocol: 8 packed prompts x 32 new tokens, then a
              prompt that hits the prefix cache, whose stream must equal
              its cold stream with the prefix cache off (where they
              part, the top-1 minus top-2 logit margin at that step is
              printed before the run fails).
3a. decode_modes — BERT-base (bf16, page 128, 8 rows, 64 pages) in each
              decode mode, every backend loading one set of weights: a
              128-token window (pages held at most ceil(128/page) + 2,
              pages evicted, all free after release; fp32 card against
              fp32 CPU for 8 steps of two long prompts at page 128 and
              16, with the CPU's unwindowed run as the yardstick; a
              512-token window equal to greedy), speculative decode
              (spec_k = 4, equal to greedy, drafts accepted; with the
              window, equal to the window alone), two beam groups of 4
              in one batch (sorted, best at least greedy's score, pages
              shared at admit) and sampling groups (replayable, packing
              independent), a session's second turn (a suffix prefill,
              equal to a cold admit), and spill/restore and
              export/import at step 10 (byte-identical pages, streams
              equal to greedy). Where two streams part, the margin is
              printed before the run fails. C6's probe: from one cache
              state, 4 greedy steps against one speculative step of 4
              rows fed the same tokens, every module's rows held bit for
              bit, printing the first op that parts for each row (none
              since the repair); the decode steps' LayerNorm
              (``LayerNorm.rows``) and LM head (tiles of 32 rows) over 8
              rows against the same rows among 32, which must give equal
              bits, beside the forms the repair replaced there, and each
              form's device ms at 8 and 32 rows. The speculative rows must
              equal greedy's bit for bit.
4. encode   — one padded BERT-base batch through ``BertEncodeBackend``.
4a. serve   — the same BERT-base served from replica processes through
              the control plane: ``Serve`` deploys the decode backend
              behind ``DecodeQueue`` (continuous batching) and the
              encode backend behind ``BatchQueue`` (micro-batches in
              buckets of 128-512), each in a spawned process warmed at
              every bucket; the 8 decode prompts go out at once as
              streamed ``POST /decode?stream=1`` to ``HttpIngress``,
              then the prefix-hit prompt, then the 8 encode requests
              through a handle. Each served stream must equal the direct
              one (the decode phase's when it ran), the hit stream the
              cold one, each served encoding a direct call bit for bit;
              B1, B4 and B5 must launch in the replicas; the deployment
              must count 9 sequences ok and none failed, its breaker
              closed. Then a disaggregated deployment (a prefill replica
              streaming each sequence replica to replica, ``admit(
              send_to=)`` then ``adopt_seq``, to a decode replica of 16
              pages) serves the 8 prompts at once: streams equal the
              direct ones, spills, restores and 8 migrations with no
              fallback, at least 8 hand-offs streamed and none by export.
              After shutdown no replica process may hold the card. Prints
              TTFT through HTTP, served tokens/s and ms a scheduler step
              beside the replica's own admit and step times, and the
              micro-batches the queue formed. Then two decode backends in
              the phase's process: a sequence streamed between them
              arrives as bf16 tensors and lands byte for byte, and a
              prefix moved over (``send_prefix``, ``adopt_prefix``)
              gives the peer a hit whose stream equals the cold one, its
              logits rows within ROW_TOL of the cold backend's.
4b. cluster — the same BERT-base served over the cluster plane: three
              node agents (``RemoteNode.spawn_local``) in a ``NodePool``
              with a journal and a failure detector, ``ClusterServe``
              with two router processes, and ``BertDecodeBackend`` (the
              serve phase's settings and warm-up) as 2 replicas spread
              over two of the agents, the third the spare capacity
              re-placements land on. The 9 decode prompts, each under a
              session key (the prefix-hit prompt under its donor's), go
              through ``ClusterHandle.call`` in 3 rounds, each answer
              equal bit for bit to the same backend's in-process
              ``call`` in the same order; then 8 clients in a closed loop
              while one replica's node is SIGKILLed: no error may reach a
              client, every answer is the prompt's in-process stream,
              the detector declares the node dead and the replica comes
              back on a survivor under its id, and the journal shows it
              removed and placed again. A sequence admitted and stepped 3
              times through ``backend_call`` on the other replica moves
              to a survivor with ``drain_node`` and finishes with an
              undisturbed call's stream. Then ``ShardedPagedDecodeBackend``
              (B4) and ``ShardedAttentionBackend`` (B1) at the parallel
              phase's shapes with ``sharding=(1, 2)``: the node's
              ``free_slots`` drop by 2 while the gang holds and come back
              on delete, each answer equal to the unsharded kernel bit
              for bit. B1, B4 and B5 must launch inside the replicas; no
              replica process may outlive the plane. Prints the routed
              and in-process latency p50/p99, requests/s before the kill
              and after the re-placement, the seconds from the kill to
              the re-placement and the drain's migrated count.
4c. encode_sparse — long-document BERT-base encode: ``BertEncodeBackend``
              with ``local_window=128`` and with ``doc_len=128``, 8
              requests of 300-500 ids padded to 512, on B1's schedule
              mode, against the dense fold on the card and fp32 against
              the CPU.
5. cpu      — three short prompts through the port on the card and on
              the CPU with the same weights; first-step logits must agree.
              Two yardsticks beside them: the card's bf16 logits against
              the CPU's fp32 ones, and a deliberately wrong CPU model.
6. profile  — decode steps, a prefill, windowed, speculative and beam
              steps and an encode batch, each timed
              on the host clock without the profiler and then traced
              under torch.profiler: the device time the trace sees over
              the unprofiled wall time is the device's busy share.
7. train    — the JAX package's ``bert_train`` leg through the port's
              experiment runner, ``tosem_tpu_torch.cli --config=bert_train
              --steps=10 --profile`` (BERT-base 8 x 512, bf16, dropout
              0.1, adamw(1e-4)): 10 timed steps with flash attention (B1
              forward, B2 and B3 backward) whose loss must fall, the same
              steps with dense attention, the flash and dense rows, B1-B3
              launched 12 a step, and the nvprof-style kernel summary of
              3 traced flash steps (``profiler/trace.py``), which must
              list B1, B2 and B3 at 12 calls a traced step each; then a
              padded batch (the kernels' segment mode), fp32 gradients
              checked flash against dense and card against CPU (with a
              wrong-model yardstick), remat full/dots against none bit
              for bit, and ``fit`` resumed after a preemption bit for
              bit.
7a. train_dp — data-parallel BERT-base training through
              ``DistributedTrainer`` (threads backend, the chain all-reduce
              over the tensor transport): the train batch as 4 logical
              shards of 2 x 512, fp32 master weights with bf16 compute,
              3 steps at world 1, 2 and 4, world 4 with ``overlap=False``,
              and world 4 with the last rank lost at step 1 and one grown
              back; each run's losses and final parameters equal to the
              single-process local fold bit for bit, B1-B3 launched 12 a
              shard computed. Prints the step ms per world beside the
              plain train step, one profiled world-4 step split into
              device kernels, copies and transport, and peak memory.
7b. parallel — the device mesh on one card, every position on it: the
              six collectives exact on integer-valued fp32 over 4
              positions; sharded flash (B1) equal to the unsharded
              kernel bit for bit at [8, 512, 12, 64] bf16 with padding
              segments over (dp, tp) = (2, 2), (1, 4) and (2, 3), and a
              12-head MultiHeadMask (schedule mode) at tp = 4; sharded
              paged decode equal to the unsharded B4 (q [8, 12, 64],
              page 128, lengths 0-512), B5 at k = 4 and B5 windowed on
              rolling tables; ShardedAttentionBackend and
              ShardedPagedDecodeBackend equal to their reference() in
              every request mode, bytes equal; the shard_map data-parallel
              step (train_dp's BERT-base job, a dp mesh of 4 positions, 3
              steps) within rtol 2e-5 of the local fold in losses and all
              199 parameters, with its step ms; ring and Ulysses attention
              at 12 heads of 64, T = 512 over sp = 4, fp32 outputs and
              gradients against the plain attention. Every sharded path's
              launches equal positions x calls. Then the device ms of the
              sharded calls beside the unsharded kernels (one card: no
              speedup is read), and ``--config=allreduce`` at its
              default of 4 positions a card (1 KB to 64 MB a position,
              each timing one graph of 256 calls), each row beside the
              card's name and power limit; on one card the "bus" is its
              memory.
7c. pipeline — BERT-base as a GPipe pipeline over pp = 4 positions on
              the card (3 layers a stage, 8 x 512 in 4 microbatches,
              flash attention): the encodings equal the layers applied
              in turn to the same microbatches bit for bit and lie within
              2e-2 of the unmicrobatched encoder; B1 launches 84 a
              forward; fp32 MLM gradients within 1e-3 of the sequential
              model's per tensor (a wrong model must break it), B1, B2
              and B3 48 each in the backward; forward and forward +
              backward ms beside the encoder's, and the bubble share.
7d. mesh_train — the global-batch mesh steps on the card:
              ``make_partitioned_train_step`` over (dp, tp, sp) = (2, 2,
              2) and ``make_train_step(mesh=)`` over dp = 4 on a batch
              whose dp shards are masked 40% and 5%; fp32 under SGD within
              1e-3 of the unsharded step per tensor, the mean of the
              shards' means breaking it; in bf16 a one-position mesh
              equal to the unsharded step bit for bit, the rules' layout
              after each step, no device tensor beyond the blocks and
              moments held between steps, B1-B3 12 a position a step,
              step ms and peak memory.
7e. benches — the benches on the card: (a) ``autotune_decode_pages``
              (B4) at (8, 12, 512, 64), (8, 12, 2048, 64) and (16, 12,
              1024, 64) bf16 and ``autotune_spec_q`` (B5) at (8, 12, 512,
              64) into a temporary cache, ``select_page_size`` and
              ``select_spec_q`` reading the winners back from it
              (``last_source == "cache"``) and a BERT-base
              ``BertDecodeBackend`` built over it decoding at the cached
              page; (b) every leg of ``run_decode_benchmarks`` once at
              BERT-base (the JAX package's workload constants, one round
              of ``BENCH_MIN_S`` windows; the window leg at t8192, w1024,
              page 128 in fp32): its answer checks raise inside the
              bench, B1, B4 and B5 launch inside the replicas and in this
              process, and each ratio prints beside the reference's
              speed floor; (c) the train_dp phase's BERT-base job with
              ``DistributedTrainer(backend="nodes")`` at world 4, each
              rank a replica process on its own node agent building
              ``"chip_smoke:dp_job"``: losses and all 199 parameters
              equal to the threads backend's and the local fold's bit for
              bit, B1-B3 12 launches a shard inside each rank; then one
              rank's agent SIGKILLed after step 1: the world shrinks to 3
              (the journal records the loss and the shrink) and the run
              equals a threads run that loses its last rank at the same
              step, bit for bit; step ms beside the threads backend's;
              (d) ``run_cluster_benchmarks`` (the CLI's ``cluster_bench``)
              once, its model replicas on the card, one round of
              ``CLUSTER_BENCH_MIN_S`` windows. No replica or rank may
              outlive its bench.
7f. configs — north-star configs 1, 2 and 4 through the port's
              experiment runner on the card (``--config=gemm,
              timing_check,conv_sweep,resnet_train`` into a temporary
              CSV): the GEMM sweep on cuBLAS (fp32 with TF32 off, bf16,
              int8), graph replay against the differential batch method
              (their 8192^3 bf16 agreement within 0.9-1.1), the ResNet-50
              conv sweeps on cuDNN (fp32 and bf16, batch 32), and 20
              ResNet-50 training steps at batch 256 (finite loss), then
              3 more traced by the config's ``--profile`` and read back
              from its kernel summary (device ms and busy share a step). Every
              GFLOPS row must read under the card's peak for its dtype
              (an fp32 row above 67 TFLOP/s means TF32 leaked in). The
              space-to-depth stem equals the 7x7 stride-2 conv within
              1e-5 of the largest output in fp32 (TF32 must break it);
              one SGD step of ``resnet18_ish`` fp32 on the card and on
              the CPU from the same weights and batch gives logits, loss
              and BatchNorm moving stats within 1e-3 of the largest value,
              and each parameter's update within 1e-2 (relative L2 norm:
              the backward); a model with a wrong weight must break both.
7g. kernel_matrix — the kernel parity harness (``ops/parity.py``) on the
              card: every scenario of the flash, paged and schedule
              matrices with the ``cuda`` arm against the ``torch`` arm
              on CPU copies within the JAX package's ``TOLERANCES`` (B1
              with its mask dropped must break it); then
              ``--config=kernel_matrix`` (the cross-backend bench: the
              ``cuda`` arms by graph replay, the ``torch`` arms at host
              rates) and the block-sparse bench (``ops/bench_sparse.py``:
              ``LocalMask(1024)`` against causal at t8192, bf16).
7h. moe     — MoE-BERT at BERT-base widths (``BertConfig.base()`` with
              ``moe_experts=4``: every second layer routed, k 2, capacity
              1.25, bf16, dropout 0.1), weights from seed 0: an 8 x 512
              encode through ``encode_fn(attn_fn=flash_attn_fn())`` (B1
              12 launches), 10 MLM steps (adamw(1e-4), loss + 0.01 aux;
              B1-B3 12 launches a step each) whose loss must fall, 2 more
              traced for the device breakdown, the capacity drops before
              and after; ``bert_tiny_moe(4)`` fp32 card vs CPU
              (encodings, aux, MLM logits within 1e-3 of the largest
              value; a model with one routed layer's experts off by 10%
              must break it); the MoE layer at BERT-base widths over ep =
              4 positions (``ExpertParallelMoE``) against the unsharded
              layer (y within rtol/atol 2e-5, aux rel 1e-5, fp32
              gradients 1e-3 a tensor).
7i. speech  — the DeepSpeech family at ``SpeechConfig()``'s full width
              (fp32), weights from seed 0: MFCC of the synthetic corpus'
              16 WAVs card vs CPU; ``SpeechBatchBackend`` on 8
              utterances of 150-500 frames in buckets 256 and 512
              (batched == sequential by text and rows, rows within 1e-4
              of each full pass); ``SpeechDecodeBackend`` (8 rows, chunk
              8) in this process (ms a step, traced busy share) and in a
              replica behind ``DecodeQueue`` (texts == the full pass's,
              rows within 1e-4); one stream through the native speech C
              ABI in uneven chunks (text == the full pass's); CTC loss
              and gradient at [8, 500, 29] card vs CPU (1e-4) beside
              ``F.ctc_loss`` (timed only), the beam decoder with a scorer;
              3 Adam steps of full-width CTC training; ``cli
              --config=speech_train`` (four rows, device gpu, the loss
              below its first). No kernel of ``csrc/`` is on this path.
7j. detection — the detection family on the card: (a) EfficientDet-D0
              at full width (``EfficientDetConfig.d0()``: 512 px, 90
              classes, 4,336,838 parameters, 49,104 anchors; fp32, TF32
              off), weights from seed 0: a forward at batch 8, then 5 Adam
              steps (2e-3) at batch 8 on ``detection_train``'s synthetic
              boxes, whose loss must fall (ms a step, images/s, peak
              memory); (b) one SGD step of D0 at batch 2 on the card and on
              the CPU from the same weights: eval logits and boxes, loss
              and BatchNorm moving stats within 1e-3 of the largest value,
              each parameter's update within 1e-2 (relative L2), and the
              class head's conv scaled by 1.1 breaking both; (c) the CLI's
              ``detection_train`` (AP50 and AP, the loss falling),
              ``detection_infer`` (its ``.pt2`` reloaded within 1e-5 of the
              eager forward) and ``pointpillars_infer`` (the 141 x 141
              grid, 16,384 points); (d) PointPillars at that grid:
              ``apply`` card vs CPU within 1e-5 with equal masks, two
              ``detect`` launches bit for bit, and the NMS kernel
              (``nms_sweep``) equal to its plain version element for
              element on the card at n = 19,881 (the detect thresholds,
              and every box live), at 64 boxes with tied scores, at the
              chunk boundaries n = 1, 63, 64, 65 and 4,097, and at the
              detector's 60,025 boxes of a 245 x 245 grid (past the
              one-block sweep's former 49,152-box cap; against the plain
              version in row blocks), each launched twice bit for bit;
              then its time at 60,025 boxes, and at 19,881 by graph
              replay beside the plain version's and its bound from this
              run's IoU count.
8. suite    — north-star config 5 through the port's experiment runner,
              ``tosem_tpu_torch.cli --config=bert_kernels`` (BERT-base:
              8 x 512, 12 heads of 64, hidden 768, bf16) into a
              temporary CSV: flash attention fwd and fwd+bwd, dense and
              causal (B1-B3), the dense path, layernorm (B6, B7) and
              softmax (B8, B9). Then the ``flash_sparse`` leg
              (``--config=flash_sparse``: causal, local:1024 and
              doc:2048+causal at [1, 12, 8192, 64] bf16, forward and
              forward+backward). Every row must read under the card's
              peak (a row above it means a timing window closed early).

``--phases`` picks a subset (default: all twenty-two), e.g.
``build,kernels``
for a first call after a kernel change, ``build,kernels,train`` for the
training path, ``build,train_dp`` for data-parallel training,
``build,parallel`` for the device mesh, ``build,pipeline,mesh_train``
for the pipeline and the global-batch mesh steps,
``build,kernels,suite`` for the kernel suite,
``build,configs,kernel_matrix`` for configs 1, 2 and 4 and the
kernel matrix, ``build,decode,serve`` for the served path,
``build,decode,cluster``
for cluster serving, ``build,benches`` for the benches,
``build,moe,speech`` for MoE-BERT and the speech family,
``build,detection`` for the detection family, or
``build,kernels,decode,decode_modes,serve`` for the decode modes.

The launch counts of every kernel are set to 0 just before the decode,
each decode mode, the encode, the sparse encode, the train, each
data-parallel run, each sharded path, the pipelined forward and
backward, each mesh train run, each bench, the MoE encode, the MoE train
steps, the detection family's CLI entries and ``detect`` launches and the
suite paths run and read just
after (the serve, cluster and decode-bench paths' inside their
replicas: set to 0 as each replica's warm-up ends, read after its
traffic; the data-parallel ranks' inside each rank process, which
starts at 0); a kernel of the path
that never launched fails the run. A ``seconds`` line gives each
phase's time. Before the last line it prints the card's name and
power limit (``nvidia-smi``) and one ``{"kernels": [...]}`` line; the last
line is ``{"ok": true, "device": {...}}``. Any failure raises.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data-sheet peaks (dense), at its 700 W limit
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}

TOL = {"flash": {"float32": 2e-5, "bfloat16": 2e-2},
       "paged": {"float32": 5e-6, "bfloat16": 2e-2}}
# backward: (atol, rtol) of tests/test_pallas_kernels.py; bf16 gradients
# are held against the fp32 plain version of the same inputs
BWD_TOL = {"float32": (5e-4, 5e-3), "bfloat16": (0.5, 5e-2)}
# bf16 gradients are also held, each tensor as a whole, to
# max|g - w| <= BWD_REL * max|w|, against the bf16 plain backward on the
# same LSE and Delta and against the fp32 plain version: two bf16 ulps at
# the largest element. A sound kernel stays near 0.003 (same) and 0.005
# (fp32); a dK scaled by 1.05 or a dropped mask, the yardsticks checked
# beside it, reach 0.05 and above.
BWD_REL = 1.0 / 64
# B6-B9 against their plain versions: (atol, rtol) of
# tests/test_pallas_kernels.py:162-210 in fp32, 2e-2 in bf16
NORM_TOL = {"ln_fwd": {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)},
            "ln_bwd": {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)},
            "sm_fwd": {"float32": (1e-6, 1e-5), "bfloat16": (2e-2, 2e-2)},
            "sm_bwd": {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}}
# bf16 B6-B9 outputs are also held, each tensor as a whole, to
# max|g - w| <= NORM_REL * max|w| against the fp32 plain version on the
# same (bf16) inputs widened: one to two bf16 ulps of the largest element
# (2^-7 of it), where rounding the output costs at most half of one. The yardsticks
# checked beside it, a gamma off by 2% and a softmax temperature off by
# 5%, read about 0.018 and 0.046 at the suite's shapes on the CPU.
NORM_REL = 1.0 / 128
# At width 1 every B6-B9 output is a constant of the inputs (softmax 1,
# layernorm beta, gradients 0): the ratio above is 0/0 there and no
# yardstick can differ, so NORM_TOL alone holds those cases
CONSTANT_ROWS = "width 1: outputs are constants; held by NORM_TOL alone"
# the one PyTorch call that computes each of B6-B9 (timed here only)
LIBRARY_IS = {"ln_fwd": "F.layer_norm",
              "ln_bwd": "aten.native_layer_norm_backward (the autograd "
                        "backward of F.layer_norm)",
              "sm_fwd": "torch.softmax",
              "sm_bwd": "torch._softmax_backward_data"}
# the suite's shapes first, then a ragged row count, odd widths, a long
# row, and the edges of B6/B7/B8's warp-row body: its widest row (1024),
# one element and one vector wider, and N = 1 (layernorm also at 512)
LN_SHAPES = ((4096, 768), (4095, 768), (300, 1000), (64, 77), (256, 8192),
             (300, 1024), (300, 1025), (300, 1032), (64, 1), (300, 512))
SM_SHAPES = ((49152, 512), (4095, 512), (300, 1000), (64, 77), (256, 8192),
             (300, 1024), (300, 1025), (300, 1032), (64, 1))
KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "paged_decode",
           "paged_decode_multi", "ln_fwd", "ln_bwd", "sm_fwd", "sm_bwd",
           "flash_fwd_sched", "flash_bwd_dkv_sched", "flash_bwd_dq_sched",
           "nms_sweep")
SCHED = ("flash_fwd_sched", "flash_bwd_dkv_sched", "flash_bwd_dq_sched")
# B1-B3's schedule mode is checked at [2, SCHED_T, 12, 64] under these
# mask programs ("mh": 12 heads alternating CausalMask and LocalMask(128);
# "+segments": segment ids on top of the schedule)
SCHED_T = 1024
SPARSE_T = 8192     # the flash_sparse leg's sequence length
SCHED_MASKS = ("local:256", "local:128:127", "doc:256", "doc:256+causal",
               "prefix:200", "mh", "doc:256+segments")

# how the profiler names the kernels of tosem_tpu_torch/ops/csrc
PORT_PREFIX = "void (anonymous namespace)::"   # csrc kernels' names
PORT_KERNEL_NAMES = tuple(f"{PORT_PREFIX}{k}_"
                          for k in ("flash", "paged", "ln", "sm"))
SEED = 0            # weights, prompts and kernel inputs
NEW_TOKENS = 32     # generated per decode prompt


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(text):
    """``{kernel: "registers; spills"}`` from nvcc's ``-Xptxas -v``
    output, each function named by its mangled name."""
    out, name = {}, None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "Function properties for" in ln:
            name = ln.split("Function properties for")[1].strip()
        elif name and ("registers" in ln or "spill" in ln):
            out[name] = (out.get(name, "") + " " + ln.split(":")[-1]
                         .strip()).strip()
    return out


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# the bf16 bodies of B2 and B3 (csrc/flash_bwd.cu), and the SASS
# instructions each must hold: tensor-core products, ldmatrix, cp.async
BWD_TC = {"flash_bwd_dq_tc_kernel": (0, 0),
          "flash_bwd_dq_tc_sched_kernel": (0, 1),
          "flash_bwd_dkv_tc_kernel": (1, 0),
          "flash_bwd_dkv_tc_sched_kernel": (1, 1)}
SASS_NEEDS = ("HMMA", "LDSM", "LDGSTS")
# the warp-row bodies of B6, B7 and B8 (csrc/fused_norms.cu), and what
# their SASS must hold: 16-byte global loads and stores
WARP_ROW_NEEDS = ("LDG.E.128", "STG.E.128")
# their instantiations: B8 <T, V>, B6 and B7 <T, G, V>, V up to 4 (bf16
# x) or 8
WARP_ROW_BODIES = 4 + 8 + 2 * 2 * (4 + 8)
# B4/B5's chunk body (csrc/paged_decode.cu) <T, D, rows> for D = 16, 32,
# 64, 128, in both dtypes, one row or 8 a block: its SASS must hold
# 16-byte global loads
PAGED_NEEDS = ("LDG.E.128",)
PAGED_BODIES = 2 * 4 * 2


def sass_counts(lib, needs):
    """``{mangled kernel: {instruction: count}}`` of the SASS
    instructions ``needs`` in the ``cuobjdump -sass`` listing of a built
    library."""
    import re
    from tosem_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {lib}: {out.stderr[:300]}")
    funcs, name = {}, None
    for ln in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            funcs[name] = {op: 0 for op in needs}
        elif name is not None:
            for op in needs:
                funcs[name][op] += f" {op}" in ln
    return funcs


def ptxas_record(what, line, faults):
    """``ptxas -v``'s line of one entry function; a missing line or a
    spill is a fault."""
    import re
    regs = re.search(r"Used (\d+) registers", line)
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
    if regs is None or len(spills) != 2:
        faults.append(f"{what}: no ptxas line ({line!r})")
    elif any(spills):
        faults.append(f"{what} spills: {line}")
    return line


def bwd_tc_report():
    """The four bf16 entry points of B2/B3 at D = 16, 32 and 64, with the
    blocks an SM holds (``flash_bwd_tc_blocks_per_sm``) and, where this
    run built the library, the ``ptxas -v`` line. Returns (report,
    faults): a body whose SASS lacks HMMA, LDSM or LDGSTS, or that
    spills, is a fault."""
    import ctypes
    import re
    from tosem_tpu_torch.ops import _build
    lib = _build._lib_path("flash_bwd")
    sass = sass_counts(lib, SASS_NEEDS)
    built = "flash_bwd" in _build.BUILD_LOG
    ptx = ptxas_summary(_build.BUILD_LOG["flash_bwd"][1]) if built else {}
    blocks = _build.load("flash_bwd").flash_bwd_tc_blocks_per_sm
    blocks.argtypes = [ctypes.c_int] * 3
    blocks.restype = ctypes.c_int
    report, faults = {}, []
    for base, (dkv, sched) in BWD_TC.items():
        for D in (16, 32, 64):
            what = f"{base}<{D}>"
            names = [n for n in sass if re.search(rf"\d{base}ILi{D}E", n)]
            check(len(names) == 1, f"{what}: {len(names)} SASS functions")
            ops = sass[names[0]]
            if not all(ops.values()):
                faults.append(f"{what}: SASS lacks {ops}")
            rec = {"sass": ops, "blocks_per_sm": blocks(dkv, sched, D)}
            rec["ptxas"] = (ptxas_record(what, ptx.get(names[0], ""),
                                         faults)
                            if built else "not rebuilt in this run")
            report[what] = rec
    return report, faults


def warp_row_name(mangled):
    """``sm_fwd_warp<bf16,2>`` / ``ln_bwd_warp<bf16,f32,3>`` from the
    mangled name of a warp-row instantiation (a repeated bf16 argument
    is mangled as a substitution, ``S0_``)."""
    import re
    m = re.search(r"(ln_fwd|ln_bwd|sm_fwd)_warp_kernelI"
                  r"((?:13__nv_bfloat16|f|S\d*_)+)Li(\d+)E", mangled)
    if m is None:
        return mangled
    types = ["f32" if t == "f" else "bf16"
             for t in re.findall(r"13__nv_bfloat16|f|S\d*_", m.group(2))]
    return f"{m.group(1)}_warp<{','.join(types)},{m.group(3)}>"


def body_report(source, needs, pick, count, name):
    """The instantiations of ``source``'s bodies that ``pick`` selects
    from its SASS listing: the SASS counts of ``needs`` and, where this
    run built the library, the ``ptxas -v`` line of each, named by
    ``name``. Returns (report, faults): a body that lacks one of
    ``needs``, or that spills, is a fault, and so is a count other than
    ``count``."""
    from tosem_tpu_torch.ops import _build
    sass = sass_counts(_build._lib_path(source), needs)
    built = source in _build.BUILD_LOG
    ptx = ptxas_summary(_build.BUILD_LOG[source][1]) if built else {}
    names = sorted(n for n in sass if pick(n))
    check(len(names) == count,
          f"{len(names)} {source} bodies in the SASS, expected {count}")
    report, faults = {}, []
    for mangled in names:
        what = name(mangled)
        if not all(sass[mangled].values()):
            faults.append(f"{what}: SASS lacks {sass[mangled]}")
        report[what] = {
            "sass": sass[mangled],
            "ptxas": (ptxas_record(what, ptx.get(mangled, ""), faults)
                      if built else "not rebuilt in this run")}
    return report, faults


def warp_row_report():
    """Every instantiation of B6's, B7's and B8's warp-row bodies
    (``csrc/fused_norms.cu``): 16-byte global loads and stores, 0
    spills."""
    return body_report("fused_norms", WARP_ROW_NEEDS,
                       lambda n: "_warp_kernel" in n, WARP_ROW_BODIES,
                       warp_row_name)


def paged_name(mangled):
    """``paged_chunk<bf16,64,1>`` from a mangled chunk-body name."""
    import re
    m = re.search(r"paged_chunk_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E",
                  mangled)
    if m is None:
        return mangled
    t = "f32" if m.group(1) == "f" else "bf16"
    return f"paged_chunk<{t},{m.group(2)},{m.group(3)}>"


def nms_report():
    """The three kernels of N1's bitmask NMS (``csrc/nms.cu``): the
    ``ptxas -v`` line of each (registers, shared memory), 0 spills."""
    import re

    def name(mangled):
        m = re.search(r"nms_(?:gather|mask|sweep)_kernel", mangled)
        return m.group(0) if m else mangled
    return body_report("nms", (), lambda n: name(n) != n, 3, name)


def paged_report():
    """Every instantiation of B4/B5's chunk body
    (``csrc/paged_decode.cu``): 16-byte global loads, 0 spills."""
    return body_report("paged_decode", PAGED_NEEDS,
                       lambda n: "paged_chunk_kernel" in n, PAGED_BODIES,
                       paged_name)


# ---------------------------------------------------------------- kernels


def flash_case(dev, dtype, B, T, mode, gen):
    """One B1 case in the main path's [B, T, H, D] layout."""
    import torch
    from tosem_tpu_torch.ops.flash_attention import SegmentIds
    H, D = 12, 64
    tdt = getattr(torch, dtype)
    q, k, v = (torch.randn(B, T, H, D, generator=gen).to(tdt).to(dev)
               for _ in range(3))
    seg = None
    if mode == "segments":
        lengths = [max(1, T - 37 * (b + 1)) for b in range(B)]
        kv = torch.zeros(B, T, dtype=torch.int32)
        for b, n in enumerate(lengths):
            kv[b, :n] = 1
        seg = SegmentIds(torch.ones(B, T, dtype=torch.int32, device=dev),
                         kv.to(dev))
    return q, k, v, seg


def flash_work(q, seg, causal):
    """(bytes, operations) the forward needs on these inputs: q/k/v and
    segment ids read once, O and LSE written once; 4*D operations per
    visible (query, key) pair."""
    B, T, H, D = q.shape
    el = q.element_size()
    nbytes = 4 * B * T * H * D * el + B * H * T * 4
    if seg is not None:
        nbytes += 2 * B * T * 4
        pairs = T * int((seg.kv != 0).sum().item())
    elif causal:
        pairs = B * T * (T + 1) // 2
    else:
        pairs = B * T * T
    return nbytes, 4 * D * H * pairs


def run_flash(q, k, v, seg, causal):
    from tosem_tpu_torch.ops.flash_attention import _flash_fwd_cuda
    return _flash_fwd_cuda(q, k, v, seg, causal, 1.0 / 8.0, "bthd")


def plain_flash(q, k, v, seg, causal):
    from tosem_tpu_torch.ops.flash_attention import _flash_attention_torch
    return _flash_attention_torch(q, k, v, seg, causal, 1.0 / 8.0, "bthd")


def sdpa(q, k, v, seg, causal):
    """Library yardstick, timed here only (the port never calls it)."""
    import torch.nn.functional as F
    mask = None
    if seg is not None:
        mask = (seg.q[:, :, None] == seg.kv[:, None, :])[:, None]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=causal and mask is None, scale=1.0 / 8.0)


# B1's bf16 edge cases: (mode, layout, B, Tq, Tk, D). "orphan" is segment
# ids with a block of query rows whose id no key carries
B1_EDGES = (("dense", "bhtd", 2, 512, 512, 64),
            ("causal", "bhtd", 1, 333, 333, 64),
            ("segments", "bhtd", 8, 512, 512, 64),
            ("dense", "bthd", 2, 512, 333, 64),
            ("causal", "bthd", 2, 512, 333, 64),
            ("orphan", "bthd", 2, 512, 333, 64),
            ("orphan", "bhtd", 2, 512, 512, 64),
            ("causal", "bthd", 2, 512, 512, 32),
            ("segments", "bthd", 2, 300, 300, 16))
# SDPA's backends, each timed where it accepts the call (yardstick only)
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")


def edge_inputs(dev, gen, mode, layout, B, Tq, Tk, D, H=12):
    """bf16 q, k, v, dO and segment ids (or None) of one B1_EDGES case."""
    import torch
    from tosem_tpu_torch.ops import flash_attention as fa
    shape = ((lambda T: (B, T, H, D)) if layout == "bthd"
             else (lambda T: (B, H, T, D)))
    q = torch.randn(*shape(Tq), generator=gen)
    k, v = (torch.randn(*shape(Tk), generator=gen) for _ in range(2))
    do = torch.randn(*shape(Tq), generator=gen)
    if mode == "orphan":
        # V's mean of 1 makes a padded key that counted in an orphan
        # row's average show: at Tk 333 it would pull the row toward
        # 0 by the padded share of the last tile (51 of 384 keys)
        v = v + 1.0
    q, k, v, do = (x.to(torch.bfloat16).to(dev) for x in (q, k, v, do))
    seg = None
    if mode in ("segments", "orphan"):
        qi = torch.ones(B, Tq, dtype=torch.int32)
        ki = torch.ones(B, Tk, dtype=torch.int32)
        ki[:, Tk // 2:] = 2
        qi[:, Tq // 2:] = 2
        if mode == "orphan":
            qi[:, 100:164] = 7      # no key has id 7
        else:
            for b in range(B):
                ki[b, Tk - 13 * (b + 1):] = 3
                qi[b, Tq - 29 * (b + 1):] = 3
        seg = fa.SegmentIds(qi.to(dev), ki.to(dev))
    return q, k, v, do, seg


def b1_edge_cases(dev, gen):
    """bf16 B1 at the tensor-core body's edges against its plain version
    (2e-2, LSE 1e-3): the bhtd layout, Tq != Tk with a ragged Tk, rows
    whose segment has no key (their -1e30 average and LSE), D = 32 and
    16; every case launched twice, bit for bit."""
    import torch
    from tosem_tpu_torch.ops import flash_attention as fa
    cases = []
    for mode, layout, B, Tq, Tk, D in B1_EDGES:
        H = 12
        q, k, v, _, seg = edge_inputs(dev, gen, mode, layout, B, Tq, Tk, D)
        causal = mode == "causal"
        out, lse = fa._flash_fwd_cuda(q, k, v, seg, causal, 1.0 / 8.0, layout)
        again, lse2 = fa._flash_fwd_cuda(q, k, v, seg, causal, 1.0 / 8.0,
                                         layout)
        ref, ref_lse = fa._flash_attention_torch(q, k, v, seg, causal,
                                                 1.0 / 8.0, layout)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        bits = torch.equal(out, again) and torch.equal(lse, lse2)
        what = f"flash_fwd bf16 {mode} {layout} [{B},{Tq}x{Tk},{D}]"
        check(err <= TOL["flash"]["bfloat16"] and lse_err <= 1e-3,
              f"{what}: err {err}, lse {lse_err}")
        check(bits, f"{what} differs between two launches")
        rec = {"kernel": "flash_fwd", "mode": mode, "dtype": "bfloat16",
               "layout": layout, "shape": [B, Tq, Tk, H, D],
               "max_abs_err": err, "lse_err": lse_err,
               "bit_deterministic": bits}
        if mode == "orphan":
            rows = (slice(None), slice(100, 164))
            rows = rows if layout == "bthd" else (slice(None), slice(None),
                                                  slice(100, 164))
            rec["orphan_rows_err"] = (out[rows].float() - ref[rows].float()
                                      ).abs().max().item()
            rec["orphan_lse"] = lse[:, :, 100:164].max().item()
        cases.append(rec)
    return cases


def bwd_edge_cases(dev, gen):
    """bf16 B2 and B3 at the same edges as B1 (B1_EDGES: bhtd, Tq != Tk
    with a ragged Tk in dense and causal mode, causal 333 x 333, rows
    whose segment has no key, D = 32 and 16), each held to BWD_TOL
    against the fp32 plain backward and to BWD_REL with its yardsticks,
    and launched twice, bit for bit."""
    import torch
    from tosem_tpu_torch.ops.common import precision
    cases = []
    for mode, layout, B, Tq, Tk, D in B1_EDGES:
        q, k, v, do, seg = edge_inputs(dev, gen, mode, layout, B, Tq, Tk, D)
        causal = mode == "causal"
        got, lse, delta = run_bwd(q, k, v, do, seg, causal, layout)
        again, _, _ = run_bwd(q, k, v, do, seg, causal, layout)
        with precision("float32"):
            ref32 = plain_bwd_fp32(q, k, v, do, seg, causal, layout)
            same = plain_bwd(q, k, v, do, lse, delta, seg, causal, layout)
        torch.cuda.synchronize()
        what = f"flash bwd bf16 {mode} {layout} [{B},{Tq}x{Tk},{D}]"
        atol, rtol = BWD_TOL["bfloat16"]
        errs, ok = sched_grad_errs(got, ref32, same, atol, rtol)
        check(ok, f"{what} outside atol {atol} / rtol {rtol}: {errs}")
        rel = bwd_rel_check(q, k, v, do, lse, delta, seg, causal, layout,
                            got, same, ref32)
        bits = all(torch.equal(a, b) for a, b in zip(got, again))
        check(bits, f"{what} differs between two launches")
        cases.append({"kernel": "flash_bwd", "mode": mode,
                      "dtype": "bfloat16", "layout": layout,
                      "shape": [B, Tq, Tk, 12, D], "max_abs_err": errs,
                      "rel_err": rel, "bit_deterministic": bits})
        del got, again, ref32, same
    return cases


def sdpa_backends(call, args, names=SDPA_BACKENDS):
    """The SDPA backends of ``names`` that accept ``call(*args)``, each
    pinned by ``torch.nn.attention.sdpa_kernel``: ``({name: op}, {name:
    why refused})``. The yardstick only: the port never calls SDPA."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    ok, refused = {}, {}
    for name in names:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            refused[name] = "not in this torch"
            continue

        def op(*a, backend=backend):
            with sdpa_kernel(backend):
                return call(*a)
        try:
            op(*args)
            torch.cuda.synchronize()
        except RuntimeError as e:       # this backend refuses the call
            refused[name] = str(e).strip().splitlines()[0][:160]
            continue
        ok[name] = op
    return ok, refused


def time_turns(kernel, kargs, library, largs):
    """A kernel (``kernel(*kargs)``) and SDPA (each op of ``library``, a
    map from backend to op, on ``largs``) by ``device_ms``, in turns
    (kernel, library, library, kernel), so that a drift of the card's
    clocks shows in the spread. Returns the record's timing keys."""
    k1 = device_ms(kernel, *kargs)
    lib = {n: [device_ms(op, *largs)] for n, op in library.items()}
    for n, op in library.items():
        lib[n].append(device_ms(op, *largs))
    k2 = device_ms(kernel, *kargs)
    lib_mean = {n: sum(ts) / 2 for n, ts in lib.items()}
    best = min(lib_mean, key=lib_mean.get)
    return {"ms": (k1 + k2) / 2, "ms_turns": [k1, k2],
            "sdpa_ms_by_backend": lib, "library_ms": lib_mean[best],
            "library_is": f"sdpa, {best} backend (the fastest of those that "
                          "accept the call)",
            "timing": "DeviceLoopBench (CUDA graph, L2-cold), mean of two "
                      "turns"}


def sdpa_masked(q, k, v, am):
    """SDPA on bthd operands with a boolean attn_mask (yardstick only)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=am, scale=1.0 / 8.0)


def time_b1_dense(q, k, v, seg, lines, rec):
    """B1 bf16 at the encode batch's [8, 512, 12, 64] with key padding
    (segments): the kernels line of flash_fwd."""
    from tosem_tpu_torch.ops import flash_attention as fa
    nbytes, ops = flash_work(q, seg, False)
    am = (seg.q[:, :, None] == seg.kv[:, None, :])[:, None]

    def kernel(q, k, v, sq, skv):
        return fa._flash_fwd_cuda(q, k, v, fa.SegmentIds(sq, skv), False,
                                  1.0 / 8.0, "bthd")
    library, refused = sdpa_backends(sdpa_masked, (q, k, v, am))
    check(library, f"no SDPA backend accepts the B1 yardstick: {refused}")
    rec.update(time_turns(kernel, (q, k, v, seg.q, seg.kv), library,
                          (q, k, v, am)))
    rec["sdpa_refused"] = refused
    rec["plain_ms"] = cuda_ms(lambda: plain_flash(q, k, v, seg, False),
                              iters=5)
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, "bfloat16")
    lines["flash_fwd"] = rec


def bwd_work(q, seg, which):
    """(bytes, operations) of B2 (``which="dkv"``) or B3 (``"dq"``) on
    these inputs: q, k, v, dO, LSE, Delta and segment ids read once, the
    gradients written once; 8*D (dK/dV) or 6*D (dQ) operations per
    visible (query, key) pair."""
    B, T, H, D = q.shape
    el = q.element_size()
    grads = 2 if which == "dkv" else 1
    nbytes = (4 + grads) * B * T * H * D * el + 2 * B * H * T * 4
    if seg is not None:
        nbytes += 2 * B * T * 4
        pairs = T * int((seg.kv != 0).sum().item())
    else:
        pairs = B * T * T
    return nbytes, (8 if which == "dkv" else 6) * D * H * pairs


def run_bwd(q, k, v, do, seg, causal, layout):
    """B1 forward, Delta, then B2 and B3. Returns ``((dq, dk, dv), lse,
    delta)``."""
    from tosem_tpu_torch.ops import flash_attention as fa
    out, lse = fa._flash_fwd_cuda(q, k, v, seg, causal, 1.0 / 8.0, layout)
    delta = fa._bwd_delta(do, out, layout)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, seg, causal,
                                    1.0 / 8.0, layout)
    dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, seg, causal,
                               1.0 / 8.0, layout)
    return (dq, dk, dv), lse, delta


def plain_bwd(q, k, v, do, lse, delta, seg, causal, layout, mask=None):
    from tosem_tpu_torch.ops import flash_attention as fa
    dk, dv = fa._flash_bwd_dkv_torch(q, k, v, do, lse, delta, seg, causal,
                                     1.0 / 8.0, layout, mask)
    dq = fa._flash_bwd_dq_torch(q, k, v, do, lse, delta, seg, causal,
                                1.0 / 8.0, layout, mask)
    return dq, dk, dv


def plain_bwd_fp32(q, k, v, do, seg, causal, layout, mask=None):
    """The plain forward and backward on the fp32 copies of the inputs."""
    from tosem_tpu_torch.ops import flash_attention as fa
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    out, lse = fa._flash_attention_torch(qf, kf, vf, seg, causal, 1.0 / 8.0,
                                         layout, mask)
    delta = fa._bwd_delta(dof, out, layout)
    return plain_bwd(qf, kf, vf, dof, lse, delta, seg, causal, layout, mask)


def sdpa_fwd_bwd(q, k, v, do, am):
    """Library yardstick for the whole attention step, timed here only:
    SDPA's forward and its autograd backward on bhtd views of the bthd
    operands, with ``am`` (a boolean attn_mask) or none."""
    import torch
    import torch.nn.functional as F
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am,
                                         scale=1.0 / 8.0)
    return torch.autograd.grad(out, (qs, ks, vs), do.transpose(1, 2))


# SDPA's fused backends, each with its aten forward and backward ops (the
# MATH backend has no backward op of its own, and materializes the scores)
SDPA_FUSED = ("CUDNN_ATTENTION", "EFFICIENT_ATTENTION", "FLASH_ATTENTION")
SDPA_ATEN = {"CUDNN_ATTENTION": "cudnn", "EFFICIENT_ATTENTION": "efficient",
             "FLASH_ATTENTION": "flash"}


def _by_name(op, vals):
    """Call an aten op with the values of ``vals`` that its schema names."""
    return op(**{a.name: vals[a.name] for a in op._schema.arguments
                 if a.name in vals})


def sdpa_bwd_ops(q, k, v, do, bias):
    """SDPA's backward alone, the library call for Delta + B2 + B3: for each
    fused backend, its aten backward op fed the outputs of its own aten
    forward op on bhtd views of the bthd operands, with ``bias`` (an
    additive mask, [B|1, 1, Tq, Tk]) or none. Flash attention takes no
    mask. Returns ``({name: (op, args)}, {name: why refused})``; ``op``
    takes (dO, q, k, v, out, LSE) and returns (dq, dk, dv, ...)."""
    import torch
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    B, H, Tq, _ = qh.shape
    if bias is not None:
        bias = bias.expand(B, H, Tq, kh.shape[2])
    ok, refused = {}, {}
    for name in SDPA_FUSED:
        if bias is not None and name == "FLASH_ATTENTION":
            refused[name] = "the flash backend takes no mask"
            continue
        aten = SDPA_ATEN[name]
        vals = {"query": qh, "key": kh, "value": vh, "attn_bias": bias,
                "compute_log_sumexp": True, "dropout_p": 0.0,
                "is_causal": False, "return_debug_mask": False,
                "scale": 1.0 / 8.0}
        try:
            fwd = getattr(torch.ops.aten,
                          f"_scaled_dot_product_{aten}_attention").default
            bwd = getattr(torch.ops.aten, f"_scaled_dot_product_{aten}"
                          "_attention_backward").default
            outs = dict(zip((r.name for r in fwd._schema.returns),
                            _by_name(fwd, vals)))
            # the names of the RNG state and the LSE differ by backend
            outs.setdefault("philox_seed", outs.get("rng_state"))
            outs.setdefault("philox_offset", outs.get("unused"))
            outs.setdefault("logsumexp", outs.get("log_sumexp"))

            def op(do, q, k, v, out, lse, bwd=bwd, outs=outs):
                return _by_name(bwd, {
                    **vals, **outs, "grad_out": do, "grad_out_": do,
                    "query": q, "key": k, "value": v, "out": out,
                    "logsumexp": lse,
                    "grad_input_mask": [True, True, True, False]})
            args = (doh, qh, kh, vh, outs["output"], outs["logsumexp"])
            op(*args)
            torch.cuda.synchronize()
        except (RuntimeError, TypeError, ValueError, AttributeError) as e:
            refused[name] = str(e).strip().splitlines()[0][:160]
            continue
        ok[name] = (op, args)
    return ok, refused


def time_library(ops, refused):
    """``device_ms`` of each ``(op, args)`` of ``ops``; a backend whose
    call cannot be captured joins ``refused``. Returns (fastest ms, its
    backend, ms by backend)."""
    by = {}
    for name, (op, args) in ops.items():
        try:
            by[name] = device_ms(op, *args)
        except RuntimeError as e:
            refused[name] = "capture: " + str(e).strip().splitlines()[0][:150]
    check(by, f"no SDPA backend could be timed: {refused}")
    best = min(by, key=by.get)
    return by[best], best, by


def sdpa_yardsticks(q, k, v, do, am):
    """SDPA's backward alone (``sdpa_bwd_ops``) and its forward with the
    autograd backward, every fused backend that accepts the case, each by
    ``device_ms``; ``am`` is a boolean mask [B|1, 1, Tq, Tk] or None."""
    import torch
    bias = None
    if am is not None:
        bias = torch.zeros(am.shape, dtype=q.dtype, device=q.device)
        bias.masked_fill_(~am, float("-inf"))
    ops, refused = sdpa_bwd_ops(q, k, v, do, bias)
    bwd_ms, bwd_by, bwd_all = time_library(ops, refused)
    del ops
    steps, step_refused = sdpa_backends(sdpa_fwd_bwd, (q, k, v, do, am),
                                        SDPA_FUSED)
    step_ms, step_by, step_all = time_library(
        {n: (op, (q, k, v, do, am)) for n, op in steps.items()},
        step_refused)
    return {"sdpa_bwd_ms": bwd_ms, "sdpa_bwd_backend": bwd_by,
            "sdpa_bwd_ms_by_backend": bwd_all, "sdpa_bwd_refused": refused,
            "sdpa_fwd_bwd_ms": step_ms, "sdpa_fwd_bwd_backend": step_by,
            "sdpa_fwd_bwd_ms_by_backend": step_all,
            "sdpa_fwd_bwd_refused": step_refused}


def bwd_cases(dev, gen, lines):
    """B2 and B3 against their plain versions in every mode, layout and
    dtype, at a ragged length and at the training shape; bit-determinism
    across two launches; times at [8, 512, 12, 64] bf16 dense and
    segments (layout bthd, the model's)."""
    import torch
    from tosem_tpu_torch.ops.common import precision
    from tosem_tpu_torch.ops import flash_attention as fa
    cases = []
    for dtype in ("bfloat16", "float32"):
        for B, T in ((2, 300), (8, 512)):
            for mode in ("dense", "causal", "segments"):
                for layout in ("bthd", "bhtd"):
                    q, k, v, seg = flash_case(dev, dtype, B, T, mode, gen)
                    do = torch.randn(q.shape, generator=gen).to(q.dtype)
                    do = do.to(dev)
                    if layout == "bhtd":
                        q, k, v, do = (x.transpose(1, 2)
                                       for x in (q, k, v, do))
                        do = do.contiguous()
                    causal = mode == "causal"
                    got, lse, delta = run_bwd(q, k, v, do, seg, causal,
                                              layout)
                    again, _, _ = run_bwd(q, k, v, do, seg, causal, layout)
                    with precision("float32"):
                        ref32 = plain_bwd_fp32(q, k, v, do, seg, causal,
                                               layout)
                        same = plain_bwd(q, k, v, do, lse, delta, seg,
                                         causal, layout)
                    torch.cuda.synchronize()
                    atol, rtol = BWD_TOL[dtype]
                    want = ref32 if dtype == "bfloat16" else same
                    errs, ok = {}, True
                    for name, g, w, s in zip(("dq", "dk", "dv"), got, want,
                                             same):
                        diff = (g.float() - w.float()).abs()
                        errs[name] = diff.max().item()
                        errs[name + "_vs_same_dtype"] = (
                            g.float() - s.float()).abs().max().item()
                        ok &= bool((diff <= atol + rtol * w.float().abs())
                                   .all().item())
                    check(ok, f"flash bwd {mode} {dtype} {layout} [{B},{T}] "
                              f"outside atol {atol} / rtol {rtol}: {errs}")
                    rel = None
                    if dtype == "bfloat16":
                        rel = bwd_rel_check(q, k, v, do, lse, delta, seg,
                                            causal, layout, got, same, ref32)
                    bits = all(torch.equal(a, b) for a, b in zip(got, again))
                    check(bits, f"flash bwd {mode} {dtype} {layout} "
                                "differs between two launches")
                    rec = {"kernel": "flash_bwd", "mode": mode,
                           "dtype": dtype, "layout": layout,
                           "shape": [B, T, 12, 64], "max_abs_err": errs,
                           "against": ("plain fp32" if dtype == "bfloat16"
                                       else "plain, same inputs"),
                           "bit_deterministic": bits}
                    if rel is not None:
                        rec["rel_err"] = rel
                    if (dtype, B, layout) == ("bfloat16", 8, "bthd") \
                            and mode != "causal":
                        rec.update(time_bwd(q, k, v, do, lse, delta, seg,
                                            errs, lines, mode))
                    cases.append(rec)
                    del got, again, ref32, same
    return cases


def rel_err(g, w):
    """max|g - w| / max|w| over one gradient tensor."""
    return ((g.float() - w.float()).abs().max()
            / w.float().abs().max()).item()


def bwd_rel_check(q, k, v, do, lse, delta, seg, causal, layout, got, same,
                  ref32, mask=None):
    """Hold bf16 B2/B3 gradients to ``BWD_REL`` of their largest element
    against ``same`` (the bf16 plain backward on the kernel's LSE and
    Delta) and ``ref32``, and show that the check catches wrong
    gradients: ``same`` with dK scaled by 1.05, and, where the case has a
    mask (causal, segments or a mask program), the plain backward with
    the mask dropped."""
    names = ("dq", "dk", "dv")
    out = {"limit": BWD_REL}

    def within(errs):
        # a NaN error is not within the limit (max() would drop it)
        return all(e <= BWD_REL for e in errs)
    for against, want in (("same", same), ("fp32", ref32)):
        r = {n: rel_err(g, w) for n, g, w in zip(names, got, want)}
        out[against] = r
        check(within(r.values()),
              f"flash bwd bf16 {layout}: max|g - w| / max|w| against "
              f"{against} above {BWD_REL}: {r}")
    wrong = {"dk_x1.05": (same[0], same[1].float() * 1.05, same[2])}
    if causal or seg is not None or mask is not None:
        # on the masked LSE: a row that sees no key (LSE -1e30) reads
        # NaN here, which the check rejects as it must
        wrong["mask_dropped"] = plain_bwd(q, k, v, do, lse, delta, None,
                                          False, layout)
    out["yardsticks"] = {}
    for what, bad in wrong.items():
        errs = [rel_err(b, w) for b, w in zip(bad, same)]
        out["yardsticks"][what] = errs
        check(not within(errs), f"the bf16 gradient check missed the "
                                f"yardstick {what}: {errs}")
    return out


def time_bwd(q, k, v, do, lse, delta, seg, errs, lines, mode):
    """B2 and B3 timed alone by ``device_ms``, their plain versions (CUDA
    events), the bound of each, the port's backward (Delta + B2 + B3)
    beside SDPA's backward alone, and the port's whole step (B1 + Delta +
    B2 + B3) beside SDPA's forward and backward. Dense mode fills the
    kernel lines (the train step's mode)."""
    from tosem_tpu_torch.ops import flash_attention as fa
    out, _ = run_flash(q, k, v, seg, False)
    am = None
    if seg is not None:
        am = (seg.q[:, :, None] == seg.kv[:, None, :])[:, None]
    yard = sdpa_yardsticks(q, k, v, do, am)
    timed = {
        "port_fwd_bwd_ms": device_ms(
            lambda q, k, v, do: run_bwd(q, k, v, do, seg, False, "bthd"),
            q, k, v, do),
        "port_bwd_ms": device_ms(
            lambda q, k, v, o, lse, do: fa._flash_bwd_cuda(
                q, k, v, o, lse, do, seg, False, 1.0 / 8.0, "bthd"),
            q, k, v, out, lse, do),
        **yard}
    out = dict(timed)
    for name, kern, plain, err in (
            ("flash_bwd_dkv", fa._flash_bwd_dkv_cuda,
             fa._flash_bwd_dkv_torch, max(errs["dk"], errs["dv"])),
            ("flash_bwd_dq", fa._flash_bwd_dq_cuda, fa._flash_bwd_dq_torch,
             errs["dq"])):
        nbytes, ops = bwd_work(q, seg, name[len("flash_bwd_"):])
        b_ms, b_by = bound(nbytes, ops, "bfloat16")
        rec = {"ms": device_ms(
                   lambda q, k, v, do, lse, delta, kern=kern: kern(
                       q, k, v, do, lse, delta, seg, False, 1.0 / 8.0,
                       "bthd"), q, k, v, do, lse, delta),
               "plain_ms": cuda_ms(lambda: plain(
                   q, k, v, do, lse, delta, seg, False, 1.0 / 8.0, "bthd"),
                   iters=5),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": yard["sdpa_bwd_ms"],
               "library_is": f"SDPA's backward alone, aten "
                             f"{SDPA_ATEN[yard['sdpa_bwd_backend']]} op "
                             "(computes Delta, dK/dV and dQ together: "
                             "compare port_bwd_ms)",
               **timed, "max_abs_err": err, "dtype": "bfloat16",
               "shape": list(q.shape), "mode": mode,
               "timing": "ms, library and port figures: DeviceLoopBench "
                         "(CUDA graph, L2-cold); plain_ms: CUDA events"}
        out[name] = rec
        if mode == "dense":
            lines[name] = rec
    return out


def sched_mask(name, T):
    """The mask program of one SCHED_MASKS entry at length T."""
    from tosem_tpu_torch.ops.mask_programs import (CausalMask, LocalMask,
                                                   MultiHeadMask,
                                                   mask_from_spec)
    if name == "mh":
        return MultiHeadMask([CausalMask() if h % 2 == 0 else LocalMask(128)
                              for h in range(12)])
    return mask_from_spec(name.replace("+segments", ""), T)


def sched_programs(mask, T, H=12):
    """The mask's programs at the kernels' 64 x 64 tiles."""
    from tosem_tpu_torch.ops.flash_blocks import BlockSizes
    from tosem_tpu_torch.ops.mask_programs import compile_mask_programs
    return compile_mask_programs(mask, T, T, BlockSizes(), heads=H)


def partial_as_full(progs):
    """The yardstick the schedule checks must catch: the same programs
    with every PARTIAL entry read as FULL (the bitmaps ignored)."""
    import numpy as np
    from tosem_tpu_torch.ops.mask_programs import KIND_FULL, KIND_PARTIAL
    return type(progs)(*(s._replace(kind=np.where(
        s.kind == KIND_PARTIAL, KIND_FULL, s.kind).astype(np.int32))
        for s in progs))


def seg_ids(dev, B, T, lengths=None):
    """Segment ids with q == kv: each row cut into ids 1 and 2 and a tail
    of 3, so every query still sees itself; or, with ``lengths``, the
    encoder's key padding (q ids 1, kv ids 1 on the first n keys)."""
    import torch
    from tosem_tpu_torch.ops.flash_attention import SegmentIds
    if lengths is not None:
        kv = torch.zeros(B, T, dtype=torch.int32)
        for b, n in enumerate(lengths):
            kv[b, :n] = 1
        return SegmentIds(torch.ones(B, T, dtype=torch.int32, device=dev),
                          kv.to(dev))
    ids = torch.ones(B, T, dtype=torch.int32)
    for b in range(B):
        ids[b, 300 + 100 * b:] = 2
        ids[b, T - 137 * (b + 1):] = 3
    ids = ids.to(dev)
    return SegmentIds(ids, ids)


def run_sched(q, k, v, do, seg, progs, layout):
    """B1, Delta, B2 and B3 in schedule mode. Returns ``(out, lse, (dq,
    dk, dv), delta)``."""
    from tosem_tpu_torch.ops import flash_attention as fa
    out, lse = fa._flash_fwd_cuda(q, k, v, seg, False, 1.0 / 8.0, layout,
                                  progs)
    delta = fa._bwd_delta(do, out, layout)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, seg, False,
                                    1.0 / 8.0, layout, progs)
    dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, seg, False,
                               1.0 / 8.0, layout, progs)
    return out, lse, (dq, dk, dv), delta


def sdpa_mask(mask, seg, T, dev):
    """The dense boolean attn_mask of a mask program (and segment ids)
    for the SDPA yardstick: [1|B, 12|1, T, T]."""
    import torch
    dm = torch.as_tensor(mask.dense(T, T), device=dev)
    dm = dm[None, None] if dm.ndim == 2 else dm[None]
    if seg is not None:
        dm = dm & (seg.q[:, :, None] == seg.kv[:, None, :])[:, None]
    return dm


def sched_work(q, layout, frac, which, seg):
    """(bytes, operations) of a schedule-mode kernel on these inputs: q,
    k, v (and dO, LSE, Delta for the backward) and segment ids read
    once, the outputs written once; the dense operations (4, 8 or 6 * D
    per pair) times the schedule's executed-block fraction."""
    if layout == "bthd":
        B, T, H, D = q.shape
    else:
        B, H, T, D = q.shape
    el = q.element_size()
    tensors = {"fwd": 4, "dkv": 6, "dq": 5}[which]
    stats = {"fwd": 1, "dkv": 2, "dq": 2}[which]
    nbytes = tensors * B * T * H * D * el + stats * B * H * T * 4
    if seg is not None:
        nbytes += 2 * B * T * 4
    per_pair = {"fwd": 4, "dkv": 8, "dq": 6}[which] * D
    return nbytes, per_pair * B * H * T * T * frac


def sched_grad_errs(got, want, same, atol, rtol):
    """(max abs error per gradient, all within atol + rtol * |want|)."""
    errs, ok = {}, True
    for name, g, w, s in zip(("dq", "dk", "dv"), got, want, same):
        diff = (g.float() - w.float()).abs()
        errs[name] = diff.max().item()
        errs[name + "_vs_same_dtype"] = (g.float() - s.float()).abs() \
            .max().item()
        ok &= bool((diff <= atol + rtol * w.float().abs()).all().item())
    return errs, ok


def sched_cases(dev, gen):
    """B1-B3 in schedule mode against their plain versions (the mask
    folded densely) at [2, 1024, 12, 64], both layouts, fp32 and bf16,
    under every SCHED_MASKS program; B2/B3 launched twice, bit for bit;
    the PARTIAL-as-FULL yardstick caught; FullMask == dense and
    CausalMask == causal bit for bit, forward and backward."""
    import torch
    from tosem_tpu_torch.ops import flash_attention as fa
    from tosem_tpu_torch.ops.common import precision
    from tosem_tpu_torch.ops.mask_programs import (KIND_PARTIAL, CausalMask,
                                                   FullMask)
    B, T, H, D = 2, SCHED_T, 12, 64
    cases = []
    for name in SCHED_MASKS:
        mask = sched_mask(name, T)
        progs = sched_programs(mask, T)
        has_partial = any(bool((s.kind == KIND_PARTIAL).any())
                          for s in progs)
        for dtype in ("float32", "bfloat16"):
            for layout in ("bthd", "bhtd"):
                tdt = getattr(torch, dtype)
                shape = (B, T, H, D) if layout == "bthd" else (B, H, T, D)
                q, k, v, do = (torch.randn(*shape, generator=gen).to(tdt)
                               .to(dev) for _ in range(4))
                seg = seg_ids(dev, B, T) if name.endswith("+segments") \
                    else None
                out, lse, got, delta = run_sched(q, k, v, do, seg, progs,
                                                 layout)
                _, _, again, _ = run_sched(q, k, v, do, seg, progs, layout)
                ref, ref_lse = fa._flash_attention_torch(
                    q, k, v, seg, False, 1.0 / 8.0, layout, mask)
                with precision("float32"):
                    ref32 = plain_bwd_fp32(q, k, v, do, seg, False, layout,
                                           mask)
                    same = plain_bwd(q, k, v, do, lse, delta, seg, False,
                                     layout, mask)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                lse_err = (lse - ref_lse).abs().max().item()
                check(err <= TOL["flash"][dtype] and lse_err <= 1e-3,
                      f"flash_fwd_sched {name} {dtype} {layout}: err {err}, "
                      f"lse {lse_err}")
                atol, rtol = BWD_TOL[dtype]
                want = ref32 if dtype == "bfloat16" else same
                errs, ok = sched_grad_errs(got, want, same, atol, rtol)
                check(ok, f"flash bwd sched {name} {dtype} {layout} outside "
                          f"atol {atol} / rtol {rtol}: {errs}")
                bits = all(torch.equal(a, b) for a, b in zip(got, again))
                check(bits, f"flash bwd sched {name} {dtype} {layout} "
                            "differs between two launches")
                rec = {"kernel": "flash_*_sched", "mask": name,
                       "dtype": dtype, "layout": layout,
                       "shape": list(shape), "max_abs_err": err,
                       "lse_err": lse_err, "grad_err": errs,
                       "bit_deterministic": bits}
                if dtype == "bfloat16":
                    rec["rel_err"] = bwd_rel_check(
                        q, k, v, do, lse, delta, seg, False, layout, got,
                        same, ref32, mask)
                if (dtype, layout) == ("float32", "bthd"):
                    rec["partial_as_full"] = sched_yardstick(
                        q, k, v, do, seg, progs, layout, ref, want, same,
                        has_partial, name)
                cases.append(rec)
                del got, again, ref32, same
    # bit pins: FullMask == dense, CausalMask == causal (fwd and bwd)
    for dtype in ("bfloat16", "float32"):
        tdt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(B, T, H, D, generator=gen).to(tdt).to(dev)
                       for _ in range(4))
        pins = {}
        for mask, causal in ((FullMask(), False), (CausalMask(), True)):
            o1, l1, g1, _ = run_sched(q, k, v, do, None,
                                      sched_programs(mask, T), "bthd")
            g0, l0, _ = run_bwd(q, k, v, do, None, causal, "bthd")
            o0, _ = run_flash(q, k, v, None, causal)
            same = (torch.equal(o0, o1) and torch.equal(l0, l1)
                    and all(torch.equal(a, b) for a, b in zip(g0, g1)))
            pins[mask.signature()] = same
            check(same, f"mask={mask.signature()} differs from the "
                        f"{'causal' if causal else 'dense'} mode ({dtype})")
        cases.append({"kernel": "flash_*_sched", "dtype": dtype,
                      "shape": [B, T, H, D], "bit_equal_to_dense_modes": pins})
    torch.cuda.empty_cache()
    return cases


def sched_yardstick(q, k, v, do, seg, progs, layout, ref, want, same,
                    has_partial, name):
    """Run the PARTIAL-as-FULL programs and show the checks fail on them
    (where the schedule has partial entries at all)."""
    import torch
    if not has_partial:
        return "no partial entries"
    out, _, got, _ = run_sched(q, k, v, do, seg, partial_as_full(progs),
                               layout)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    atol, rtol = BWD_TOL["float32"]
    errs, ok = sched_grad_errs(got, want, same, atol, rtol)
    check(err > TOL["flash"]["float32"] and not ok,
          f"the schedule checks missed PARTIAL-as-FULL under {name}: "
          f"fwd {err}, bwd {errs}")
    return {"fwd_err": err, "bwd_err": errs}


def time_sched(dev, gen, lines):
    """The three kernels lines of the schedule mode, each at the shapes
    its main path gives it: B1 at the long-document encode's [8, 512, 12,
    64] bthd bf16 under local:128:127 with key padding; B2/B3 at the
    flash_sparse leg's [1, 12, 8192, 64] bhtd bf16 under local:1024.
    Each checked against its plain version and timed by ``device_ms``
    beside its bound, its plain version (CUDA events) and SDPA with the
    same dense mask: B1 beside SDPA's forward, B2/B3 beside SDPA's
    backward alone, the port's backward and whole step beside SDPA's."""
    import torch
    from tosem_tpu_torch.ops import flash_attention as fa
    from tosem_tpu_torch.ops.common import precision
    from tosem_tpu_torch.ops.flash_blocks import BlockSizes
    from tosem_tpu_torch.ops.mask_programs import (mask_from_spec,
                                                   program_stats)
    out = {}
    # B1 at the encode path's shape
    B, T, H, D = 8, 512, 12, 64
    mask = mask_from_spec("local:128:127", T)
    progs = sched_programs(mask, T)
    frac = program_stats(mask, T, T, BlockSizes(), heads=H)["fwd"].fraction
    q, k, v = (torch.randn(B, T, H, D, generator=gen).to(torch.bfloat16)
               .to(dev) for _ in range(3))
    lengths = [300 + 25 * b for b in range(B)]
    seg = seg_ids(dev, B, T, lengths=lengths)
    got, _ = fa._flash_fwd_cuda(q, k, v, seg, False, 1.0 / 8.0, "bthd", progs)
    ref, _ = fa._flash_attention_torch(q, k, v, seg, False, 1.0 / 8.0, "bthd",
                                       mask)
    torch.cuda.synchronize()
    # real query rows only: a padded query whose band holds no real key
    # has no visible key, and its row is garbage by design (the kernel
    # averages its scheduled tiles, the plain version every key)
    err = max((got[b, :n].float() - ref[b, :n].float()).abs().max().item()
              for b, n in enumerate(lengths))
    check(err <= TOL["flash"]["bfloat16"], f"flash_fwd_sched encode {err}")
    am = sdpa_mask(mask, seg, T, dev)
    nbytes, ops = sched_work(q, "bthd", frac, "fwd", seg)
    b_ms, b_by = bound(nbytes, ops, "bfloat16")

    def kernel(q, k, v, sq, skv):
        return fa._flash_fwd_cuda(q, k, v, fa.SegmentIds(sq, skv), False,
                                  1.0 / 8.0, "bthd", progs)
    library, refused = sdpa_backends(sdpa_masked, (q, k, v, am))
    check(library, f"no SDPA backend accepts the B1 sched yardstick: "
                   f"{refused}")
    rec = time_turns(kernel, (q, k, v, seg.q, seg.kv), library,
                     (q, k, v, am))
    rec["library_is"] += ", with the same dense boolean attn_mask"
    rec.update({
        "plain_ms": cuda_ms(lambda: fa._flash_attention_torch(
            q, k, v, seg, False, 1.0 / 8.0, "bthd", mask), iters=5),
        "sdpa_refused": refused, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": err, "executed_block_fraction": frac,
        "mask": "local:128:127+segments", "dtype": "bfloat16",
        "shape": [B, T, H, D]})
    lines["flash_fwd_sched"] = out["flash_fwd_sched"] = rec
    del q, k, v, got, ref, am
    # B2 / B3 at the flash_sparse leg's shape
    B, H, T, D = 1, 12, SPARSE_T, 64
    mask = mask_from_spec("local:1024", T)
    progs = sched_programs(mask, T)
    frac = program_stats(mask, T, T, BlockSizes(), heads=H)["bwd"].fraction
    q, k, v, do = (torch.randn(B, H, T, D, generator=gen).to(torch.bfloat16)
                   .to(dev) for _ in range(4))
    _, lse, got, delta = run_sched(q, k, v, do, None, progs, "bhtd")
    with precision("float32"):
        ref32 = plain_bwd_fp32(q, k, v, do, None, False, "bhtd", mask)
        same = plain_bwd(q, k, v, do, lse, delta, None, False, "bhtd", mask)
    torch.cuda.synchronize()
    rel = bwd_rel_check(q, k, v, do, lse, delta, None, False, "bhtd", got,
                        same, ref32, mask)
    errs = {n: (g.float() - w.float()).abs().max().item()
            for n, g, w in zip(("dq", "dk", "dv"), got, ref32)}
    del ref32
    am = sdpa_mask(mask, None, T, dev)
    # the bthd views of the bhtd operands, as the yardsticks take them
    yard = sdpa_yardsticks(*(x.transpose(1, 2) for x in (q, k, v, do)), am)
    out_, _ = fa._flash_fwd_cuda(q, k, v, None, False, 1.0 / 8.0, "bhtd",
                                 progs)
    timed = {
        "port_fwd_bwd_ms": device_ms(
            lambda q, k, v, do: run_sched(q, k, v, do, None, progs, "bhtd"),
            q, k, v, do),
        "port_bwd_ms": device_ms(
            lambda q, k, v, o, lse, do: fa._flash_bwd_cuda(
                q, k, v, o, lse, do, None, False, 1.0 / 8.0, "bhtd", progs),
            q, k, v, out_, lse, do),
        **yard}
    del out_
    for name, kern, plain, err in (
            ("flash_bwd_dkv_sched", fa._flash_bwd_dkv_cuda,
             fa._flash_bwd_dkv_torch, max(errs["dk"], errs["dv"])),
            ("flash_bwd_dq_sched", fa._flash_bwd_dq_cuda,
             fa._flash_bwd_dq_torch, errs["dq"])):
        which = name[len("flash_bwd_"):-len("_sched")]
        nbytes, ops = sched_work(q, "bhtd", frac, which, None)
        b_ms, b_by = bound(nbytes, ops, "bfloat16")
        lines[name] = out[name] = {
            "ms": device_ms(
                lambda q, k, v, do, lse, delta, kern=kern: kern(
                    q, k, v, do, lse, delta, None, False, 1.0 / 8.0, "bhtd",
                    progs), q, k, v, do, lse, delta),
            "plain_ms": cuda_ms(lambda: plain(
                q, k, v, do, lse, delta, None, False, 1.0 / 8.0, "bhtd",
                mask), iters=3, warmup=1),
            "library_ms": yard["sdpa_bwd_ms"],
            "library_is": f"SDPA's backward alone, aten "
                          f"{SDPA_ATEN[yard['sdpa_bwd_backend']]} op, with "
                          "the same mask as an additive bias (computes "
                          "Delta, dK/dV and dQ together: compare "
                          "port_bwd_ms)",
            **timed, "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "rel_err": rel, "executed_block_fraction": frac,
            "mask": "local:1024", "dtype": "bfloat16",
            "shape": [B, H, T, D],
            "timing": "ms, library and port figures: DeviceLoopBench (CUDA "
                      "graph, L2-cold); plain_ms: CUDA events"}
    del q, k, v, do, got, same, am
    torch.cuda.empty_cache()
    return out


def paged_case(dev, dtype, lens, K, gen, page=128, H=12, D=64):
    import torch
    tdt = getattr(torch, dtype)
    B = len(lens)
    W = max(1, -(-max(lens) // page))
    P = max(64, B * W + 2)
    kp = torch.randn(P, page, H, D, generator=gen).to(tdt).to(dev)
    vp = torch.randn(P, page, H, D, generator=gen).to(tdt).to(dev)
    bt = torch.randperm(P, generator=gen)[:B * W].reshape(B, W)
    bt = bt.to(torch.int32).to(dev)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    shape = (B, H, D) if K == 0 else (B, K, H, D)
    q = torch.randn(*shape, generator=gen).to(tdt).to(dev)
    return q, kp, vp, bt, sl


def paged_work(q, lens, K, page=128):
    """(bytes, operations): q, the K/V of each sequence's cached tokens,
    tables and lengths read once, the output written once; 4*D per
    visible (row, key) pair."""
    H, D = q.shape[-2], q.shape[-1]
    el = q.element_size()
    rows = max(K, 1)
    toks = sum(lens)
    nbytes = (2 * q.numel() * el + 2 * toks * H * D * el
              + 4 * len(lens) * (2 + -(-max(lens) // page)))
    pairs = sum(max(0, sl - rows + 1 + r) for sl in lens if sl > 0
                for r in range(rows))
    return nbytes, 4 * D * H * pairs


# B5's window and page-offset modes: every window below, at k = 1, 4 and
# 8 rows, over 8 sequences (one idle) on rolling tables
B5_WINDOWS = (1, 100, 128, 300)
B5_WINDOW_K = (1, 4, 8)
B5_WINDOW_LENS = [0, 9, 77, 128, 129, 300, 511, 512]


def rolling_table(bt, lens, K, window, page):
    """(narrow table, page offsets) as a windowed decode step hands B5
    them: sequence b's slots [po, po + n) of its full table, po the page
    of the lowest position its rows' windows reach, n up to its last
    page, in a table as wide as the backend's ``table_w``."""
    import torch
    B, W = bt.shape
    w = min(-(-window // page) + -(-K // page) + 3, W)
    narrow = torch.zeros((B, w), dtype=torch.int32, device=bt.device)
    po = torch.zeros((B,), dtype=torch.int32, device=bt.device)
    for b, sl in enumerate(lens):
        if sl == 0:
            continue
        p0 = max(sl - K - window + 1, 0) // page
        n = -(-sl // page) - p0
        check(n <= w, f"rolling table of {w} slots cannot hold {n} pages")
        narrow[b, :n] = bt[b, p0:p0 + n]
        po[b] = p0
    return narrow, po


def window_work(q, lens, K, window, w):
    """(bytes, operations) of a windowed B5 call: q read and the output
    written once, K and V of the keys some row of a sequence sees (the
    union of its rows' windows, min(sl, window + K - 1) keys, as
    ``paged_work`` counts ``sl``; the kernel reads the whole pages that
    hold them), tables, lengths and offsets; 4*D per visible (row, key)
    pair."""
    H, D = q.shape[-2], q.shape[-1]
    el = q.element_size()
    keys = pairs = 0
    for sl in lens:
        if sl == 0:
            continue
        keys += min(sl, window + K - 1)
        pairs += sum(min(sl - K + r + 1, window) for r in range(K))
    nbytes = (2 * q.numel() * el + 2 * keys * H * D * el
              + 4 * len(lens) * (2 + w))
    return nbytes, 4 * D * H * pairs


def b5_window_cases(dev, gen, lines):
    """B5 with ``window`` and ``page_offsets`` on rolling tables, bf16 and
    fp32, page 128 (D = 16, 64, 128) and page 16 (D = 64): against the
    plain version, twice bit for bit, row r against a k = 1 launch at
    ``sl - (k - 1 - r)`` bit for bit, the narrow table against the full
    one (within the tolerance: the chunks follow the table's width), and
    two yardsticks that must break the plain check (the window dropped,
    the offsets zeroed). Times one case by graph replay."""
    import torch
    from tosem_tpu_torch.ops import paged_attention as pa
    lens = B5_WINDOW_LENS
    cases = []
    for dtype in ("bfloat16", "float32"):
        tol = TOL["paged"][dtype]
        for page, D in ((128, 64), (16, 64), (128, 16), (128, 128)):
            for K in B5_WINDOW_K:
                q, kp, vp, bt, sl = paged_case(dev, dtype, lens, K, gen,
                                               page=page, D=D)
                scale = 1.0 / D ** 0.5
                for window in B5_WINDOWS:
                    narrow, po = rolling_table(bt, lens, K, window, page)

                    def run(qq=q, table=narrow, n=sl, offs=po, win=window):
                        return pa._paged_decode_multi_cuda(
                            qq, kp, vp, table, n, None, offs, scale, win)
                    out, again = run(), run()
                    ref = pa.paged_attention_reference(
                        q, kp, vp, narrow, sl, window=window,
                        page_offsets=po)
                    full = run(table=bt, offs=None)
                    dropped = run(win=None)
                    zeroed = run(offs=torch.zeros_like(po))
                    rows = [run(qq=q[:, r:r + 1].contiguous(),
                                n=torch.clamp(sl - (K - 1 - r), min=0))
                            for r in range(K)]
                    torch.cuda.synchronize()

                    def gap(a, b):
                        return (a.float() - b.float()).abs().max().item()
                    what = (f"B5 window {window} k={K} {dtype} page {page} "
                            f"D {D}")
                    err = gap(out, ref)
                    full_err = gap(out, full)
                    yard = {"window_dropped": gap(dropped, ref),
                            "offsets_zeroed": gap(zeroed, ref)}
                    check(err <= tol, f"{what}: err {err}")
                    check(torch.equal(out, again),
                          f"{what} differs between two launches")
                    check(bool((out[0] == 0).all().item()),
                          f"{what}: seq_len 0 row not zeros")
                    bad = [r for r in range(K)
                           if not torch.equal(out[:, r], rows[r][:, 0])]
                    check(not bad, f"{what}: rows {bad} != k = 1 launches "
                                   "at sl - (k - 1 - r)")
                    check(full_err <= tol,
                          f"{what}: rolling table vs full table {full_err}")
                    check(all(v > tol for v in yard.values()),
                          f"{what}: a yardstick passes the check: {yard}")
                    rec = {"kernel": "paged_decode_multi", "mode": "window",
                           "dtype": dtype, "k": K, "window": window,
                           "page": page, "D": D, "lens": lens,
                           "table_w": narrow.shape[1],
                           "page_offsets": po.tolist(),
                           "chunks": pa._decode_chunks(narrow.shape[1],
                                                       page),
                           "max_abs_err": err,
                           "rolling_vs_full_table": full_err,
                           "yardsticks": yard, "bit_deterministic": True,
                           "rows_equal_k1_launches": True}
                    if (dtype, page, D, K, window) == ("bfloat16", 128, 64,
                                                       1, 128):
                        w = narrow.shape[1]
                        nbytes, ops = window_work(q, lens, K, window, w)
                        rec["ms"] = device_ms(
                            lambda q, kp, vp: pa._paged_decode_multi_cuda(
                                q, kp, vp, narrow, sl, None, po, scale,
                                window), q, kp, vp)
                        rec["plain_ms"] = cuda_ms(
                            lambda: pa.paged_attention_reference(
                                q, kp, vp, narrow, sl, window=window,
                                page_offsets=po), iters=10)
                        rec["library_ms"] = None
                        rec["bound_ms"], rec["bound_by"] = bound(
                            nbytes, ops, dtype)
                        lines["paged_decode_multi_window"] = rec
                    cases.append(rec)
    return cases


def norm_err(name, dtype, got, want):
    """(max abs error, within NORM_TOL) of one B6-B9 output."""
    atol, rtol = NORM_TOL[name][dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return diff.max().item(), bool((diff <= atol + rtol * w.abs()).all()
                                   .item())


def device_ms(op, *args):
    """Device ms per call (``DeviceLoopBench``: a CUDA graph of calls over
    operand copies that span twice the L2, replays timed by events)."""
    from tosem_tpu_torch.utils.timing import DeviceLoopBench
    return DeviceLoopBench(op=op, args=args).time(reps=3) * 1e3


def norm_work(name, R, D, el):
    """(bytes, fp32 operations) of B6-B9 on [R, D] rows of ``el``-byte
    elements: inputs read once, outputs written once (B7's partials stay
    out: they are the kernel's own scratch); per element about 7 (B6),
    14 (B7), 7 (B8) and 4 (B9) operations."""
    if name == "ln_fwd":      # x, gamma, beta in; y, mu, rstd out
        return 2 * R * D * el + 2 * D * el + 2 * R * 4, 7 * R * D
    if name == "ln_bwd":      # x, dy, gamma, mu, rstd in; dx, dg, db out
        return 3 * R * D * el + 3 * D * el + 2 * R * 4, 14 * R * D
    if name == "sm_fwd":      # x in, y out
        return 2 * R * D * el, 7 * R * D
    return 3 * R * D * el, 4 * R * D   # sm_bwd: y, dy in; dx out


def norm_rel_check(what, names, got, want, yardstick, wrong, right):
    """Hold bf16 B6-B9 outputs to NORM_REL of their largest element
    against the fp32 plain version, and show that the check catches a
    wrong result (``wrong`` against ``right``)."""
    r = {n: rel_err(g, w) for n, g, w in zip(names, got, want)}
    check(max(r.values()) <= NORM_REL,
          f"{what}: max|g - w| / max|w| against fp32 above {NORM_REL}: {r}")
    r[yardstick] = rel_err(wrong, right)
    check(r[yardstick] > NORM_REL,
          f"{what}: the bf16 check missed the yardstick {yardstick}: {r}")
    return r


def time_norm(name, err, kernel, plain, library, *args):
    """The kernels line of one of B6-B9 at the suite's bf16 shape: device
    ms of the kernel, its plain version and its library call on ``args``,
    and its bound."""
    R, D = args[0].shape
    nbytes, ops = norm_work(name, R, D, args[0].element_size())
    b_ms, b_by = bound(nbytes, ops, "float32")
    return {"ms": device_ms(kernel, *args), "plain_ms": device_ms(plain, *args),
            "library_ms": device_ms(library, *args),
            "library_is": LIBRARY_IS[name], "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err, "dtype": "bfloat16",
            "shape": [R, D]}


def norm_body(n, *tensors):
    """The body B6, B7 or B8 ran on these operands (inputs and outputs),
    as ``fused_norms._row_body`` chose it before the launch."""
    from tosem_tpu_torch.ops import fused_norms as fn
    body, vecs = fn._row_body(n, tensors[0].dtype,
                              *(t.data_ptr() for t in tensors))
    return {"body": body, "V": vecs}


def off_16(randn, R, D, **kw):
    """A contiguous [R, D] view at storage offset 1: its data_ptr() sits
    2 (bf16) or 4 (fp32) bytes past a 16-byte boundary."""
    x = randn(R * D + 1, **kw)[1:].view(R, D)
    check(x.is_contiguous() and x.data_ptr() % 16 == x.element_size(),
          f"off-16 view at {x.data_ptr() % 16}")
    return x


def norm_cases(dev, seed, lines):
    """B6-B9 against their plain versions on the card at every shape of
    LN_SHAPES / SM_SHAPES in bf16 and fp32 (layernorm with gamma in
    either dtype), and at the suite's widths with x (and, for B6/B7,
    gamma) off 16 bytes; B6, B7 and B8 launched twice, bit for bit; each
    case names the body B6/B7/B8 ran (warp-row or block) and its vectors
    a lane, and the suite's shapes must run the warp-row body. At the suite's bf16 shapes each kernel is timed beside
    its bound, its plain version and its library call
    (``F.layer_norm``, its autograd backward
    ``native_layer_norm_backward``, ``torch.softmax``,
    ``torch._softmax_backward_data``), which the port never calls."""
    import torch
    import torch.nn.functional as F
    from tosem_tpu_torch.ops import fused_norms as fn
    gen = torch.Generator(dev).manual_seed(seed)
    cases = []

    def randn(*shape, scale=1.0, shift=0.0, dtype):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                + shift).to(getattr(torch, dtype))

    for dtype in ("bfloat16", "float32"):
        other = "float32" if dtype == "bfloat16" else "bfloat16"
        ln_cases = [(R, D, None, gdt) for gdt in (dtype, other)
                    for R, D in LN_SHAPES]
        ln_cases += [(*LN_SHAPES[0], "x", dtype),
                     (*LN_SHAPES[0], "gamma", dtype),
                     (*LN_SHAPES[0], "dy", dtype)]
        for R, D, off, gdt in ln_cases:
            x = (off_16(randn, R, D, scale=3.0, shift=1.0, dtype=dtype)
                 if off == "x" else
                 randn(R, D, scale=3.0, shift=1.0, dtype=dtype))
            g = (off_16(randn, 1, D, dtype=gdt)[0] if off == "gamma"
                 else randn(D, dtype=gdt))
            b = randn(D, dtype=gdt)
            dy = (off_16(randn, R, D, dtype=dtype) if off == "dy"
                  else randn(R, D, dtype=dtype))
            y, mu, rstd = fn._ln_fwd_cuda(x, g, b, 1e-6)
            fwd_again = fn._ln_fwd_cuda(x, g, b, 1e-6)
            py, pmu, prstd = fn._ln_fwd_torch(x, g, b, 1e-6)
            grads = fn._ln_bwd_cuda(x, g, mu, rstd, dy)
            again = fn._ln_bwd_cuda(x, g, mu, rstd, dy)
            plain = fn._ln_bwd_torch(x, g, mu, rstd, dy)
            torch.cuda.synchronize()
            err_y, ok_y = norm_err("ln_fwd", dtype, y, py)
            stats = max((mu - pmu).abs().max().item(),
                        ((rstd - prstd).abs() / prstd.abs()).max().item())
            # dgamma and dbeta come out in gamma's dtype: held to its budget
            errs = [norm_err("ln_bwd", t, a, w)
                    for t, a, w in zip((dtype, gdt, gdt), grads, plain)]
            fwd_bits = all(torch.equal(a, c)
                           for a, c in zip((y, mu, rstd), fwd_again))
            bits = all(torch.equal(a, c) for a, c in zip(grads, again))
            body = norm_body(D, x, g, b, y)
            bwd_body = norm_body(D, x, g, dy, grads[0])
            what = (f"[{R},{D}] gamma {gdt}"
                    + (f" {off} off 16 bytes" if off else ""))
            check(ok_y and stats <= 1e-5,
                  f"ln_fwd {dtype} {what} ({body}): err {err_y}, mu/rstd "
                  f"{stats}")
            check(fwd_bits, f"ln_fwd {dtype} {what} ({body}) differs "
                            "between two launches")
            check(all(ok for _, ok in errs),
                  f"ln_bwd {dtype} {what} ({bwd_body}): dx/dg/db err {errs}")
            check(bits, f"ln_bwd {dtype} {what} ({bwd_body}) differs between "
                        "two launches")
            if (R, D) == LN_SHAPES[0]:
                fwd_off = off in ("x", "gamma")
                check(body["body"] == ("block" if fwd_off else "warp"),
                      f"ln_fwd {dtype} {what} ran the {body} body")
                check(bwd_body["body"] == ("block" if off else "warp"),
                      f"ln_bwd {dtype} {what} ran the {bwd_body} body")
            rec = {"kernel": "ln_fwd+ln_bwd", "dtype": dtype,
                   "gamma_dtype": gdt, "shape": [R, D], "off_16": off,
                   "ln_fwd_body": body, "ln_bwd_body": bwd_body,
                   "max_abs_err": err_y, "mu_rstd_err": stats,
                   "grad_err": {n: e for n, (e, _) in
                                zip(("dx", "dgamma", "dbeta"), errs)},
                   "fwd_bit_deterministic": fwd_bits,
                   "bit_deterministic": bits}
            if dtype == "bfloat16" and D == 1:
                rec["rel_vs_fp32"] = CONSTANT_ROWS
            elif dtype == "bfloat16":
                xf, gf, bf, dyf = (t.float() for t in (x, g, b, dy))
                ry, rmu, rrstd = fn._ln_fwd_torch(xf, gf, bf, 1e-6)
                rgrads = fn._ln_bwd_torch(xf, gf, rmu, rrstd, dyf)
                rec["rel_vs_fp32"] = norm_rel_check(
                    f"ln bf16 [{R},{D}]", ("y", "dx", "dgamma", "dbeta"),
                    (y, *grads), (ry, *rgrads), "gamma_x1.02",
                    fn._ln_fwd_torch(xf, gf * 1.02, bf, 1e-6)[0], ry)
            if (dtype, gdt, R, D, off) == ("bfloat16", "bfloat16",
                                           *LN_SHAPES[0], None):
                # the library's backward takes its own saved statistics;
                # the timed operands are (x, g, b, mu, rstd, dy)
                _, lmu, lrstd = torch.native_layer_norm(x, [D], g, b, 1e-6)
                rec["ln_fwd"] = lines["ln_fwd"] = time_norm(
                    "ln_fwd", err_y,
                    lambda a, c, e: fn._ln_fwd_cuda(a, c, e, 1e-6),
                    lambda a, c, e: fn._ln_fwd_torch(a, c, e, 1e-6),
                    lambda a, c, e: F.layer_norm(a, (D,), c, e, 1e-6),
                    x, g, b)
                rec["ln_bwd"] = lines["ln_bwd"] = time_norm(
                    "ln_bwd", max(e for e, _ in errs),
                    lambda a, c, e, m, r, d: fn._ln_bwd_cuda(a, c, m, r, d),
                    lambda a, c, e, m, r, d: fn._ln_bwd_torch(a, c, m, r, d),
                    lambda a, c, e, m, r, d: torch.ops.aten
                    .native_layer_norm_backward(d, a, [D], lmu, lrstd, c, e,
                                                [True, True, True]),
                    x, g, b, mu, rstd, dy)
            cases.append(rec)
            del x, dy, y, py, fwd_again, grads, again, plain
        sm_cases = [(R, N, False) for R, N in SM_SHAPES]
        sm_cases.append((*SM_SHAPES[0], True))
        for R, N, off in sm_cases:
            x = (off_16(randn, R, N, scale=5.0, dtype=dtype) if off else
                 randn(R, N, scale=5.0, dtype=dtype))
            dy = randn(R, N, dtype=dtype)
            y = fn._sm_fwd_cuda(x)
            fwd_again = fn._sm_fwd_cuda(x)
            py = fn._sm_fwd_torch(x)
            dx = fn._sm_bwd_cuda(y, dy)     # from the kernel's own y
            pdx = fn._sm_bwd_torch(y, dy)
            torch.cuda.synchronize()
            err_y, ok_y = norm_err("sm_fwd", dtype, y, py)
            err_dx, ok_dx = norm_err("sm_bwd", dtype, dx, pdx)
            fwd_bits = torch.equal(y, fwd_again)
            body = norm_body(N, x, y)
            what = f"[{R},{N}]" + (" x off 16 bytes" if off else "")
            check(ok_y, f"sm_fwd {dtype} {what} ({body}) err {err_y}")
            check(fwd_bits, f"sm_fwd {dtype} {what} ({body}) differs "
                            "between two launches")
            check(ok_dx, f"sm_bwd {dtype} {what} err {err_dx}")
            if (R, N) == SM_SHAPES[0]:
                check(body["body"] == ("block" if off else "warp"),
                      f"sm_fwd {dtype} {what} ran the {body} body")
            rec = {"kernel": "sm_fwd+sm_bwd", "dtype": dtype,
                   "shape": [R, N], "off_16": "x" if off else None,
                   "sm_fwd_body": body, "max_abs_err": err_y,
                   "grad_err": err_dx, "fwd_bit_deterministic": fwd_bits}
            if dtype == "bfloat16" and N == 1:
                rec["rel_vs_fp32"] = CONSTANT_ROWS
            elif dtype == "bfloat16":
                ry = fn._sm_fwd_torch(x.float())
                rec["rel_vs_fp32"] = norm_rel_check(
                    f"softmax bf16 [{R},{N}]", ("y", "dx"), (y, dx),
                    (ry, fn._sm_bwd_torch(y.float(), dy.float())),
                    "temperature_x1.05", fn._sm_fwd_torch(x.float() * 1.05),
                    ry)
            if (dtype, R, N, off) == ("bfloat16", *SM_SHAPES[0], False):
                rec["sm_fwd"] = lines["sm_fwd"] = time_norm(
                    "sm_fwd", err_y, fn._sm_fwd_cuda, fn._sm_fwd_torch,
                    lambda a: torch.softmax(a, -1), x)
                rec["sm_bwd"] = lines["sm_bwd"] = time_norm(
                    "sm_bwd", err_dx, fn._sm_bwd_cuda, fn._sm_bwd_torch,
                    lambda a, d: torch._softmax_backward_data(d, a, -1,
                                                              a.dtype),
                    y, dy)
            cases.append(rec)
            del x, dy, y, py, fwd_again, dx, pdx
    torch.cuda.empty_cache()
    return cases


def phase_kernels(dev, seed):
    import torch
    from tosem_tpu_torch.ops import paged_attention as pa
    gen = torch.Generator().manual_seed(seed)
    lines = {}
    cases = norm_cases(dev, seed, lines)
    # ---- B1: dense, causal and segments at [1,512] and [8,128], a
    # ragged length, and the encode batch's shape; bf16 and fp32
    b1_cases = [(mode, B, T) for B, T in ((1, 512), (8, 128))
                for mode in ("dense", "causal", "segments")]
    b1_cases += [("causal", 1, 333), ("segments", 8, 512)]
    for dtype in ("bfloat16", "float32"):
        for mode, B, T in b1_cases:
            q, k, v, seg = flash_case(dev, dtype, B, T, mode, gen)
            causal = mode == "causal"
            out, lse = run_flash(q, k, v, seg, causal)
            ref, ref_lse = plain_flash(q, k, v, seg, causal)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            check(err <= TOL["flash"][dtype],
                  f"flash {mode} {dtype} [{B},{T}] err {err}")
            check(lse_err <= 1e-3, f"flash lse {mode} {dtype} {lse_err}")
            rec = {"kernel": "flash_fwd", "mode": mode, "dtype": dtype,
                   "shape": [B, T, 12, 64], "max_abs_err": err,
                   "lse_err": lse_err}
            if (mode, B, T, dtype) == ("segments", 8, 512, "bfloat16"):
                time_b1_dense(q, k, v, seg, lines, rec)
            elif (mode, B, T) in (("segments", 8, 512), ("causal", 1, 512)):
                nbytes, ops = flash_work(q, seg, causal)
                rec["ms"] = device_ms(
                    lambda q, k, v: run_flash(q, k, v, seg, causal), q, k, v)
                rec["plain_ms"] = cuda_ms(
                    lambda: plain_flash(q, k, v, seg, causal), iters=5)
                rec["library_ms"] = device_ms(
                    lambda q, k, v: sdpa(q, k, v, seg, causal), q, k, v)
                rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, dtype)
            cases.append(rec)
    cases += b1_edge_cases(dev, gen)
    # ---- B4: 8 sequences with ragged lengths up to 512, one idle row, at
    # the main path's page 128, a wide table (page 16: 32 slots, 8 a
    # chunk) and every head dim the kernel takes
    lens = [0, 1, 77, 128, 129, 300, 511, 512]
    b4_cases = [(128, 64), (16, 64), (128, 16), (128, 32), (128, 128)]
    for dtype in ("bfloat16", "float32"):
        for page, D in b4_cases:
            q, kp, vp, bt, sl = paged_case(dev, dtype, lens, 0, gen, page=page,
                                           D=D)
            scale = 1.0 / D ** 0.5
            out = pa._paged_decode_cuda(q, kp, vp, bt, sl, scale)
            again = pa._paged_decode_cuda(q, kp, vp, bt, sl, scale)
            ref = pa.paged_attention_reference(q, kp, vp, bt, sl)
            multi1 = pa._paged_decode_multi_cuda(q[:, None].contiguous(), kp,
                                                 vp, bt, sl, None, None,
                                                 scale, None)[:, 0]
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            what = f"{dtype} page {page} D {D}"
            check(err <= TOL["paged"][dtype], f"paged_decode {what} err {err}")
            check(bool((out[0] == 0).all().item()),
                  f"paged_decode {what}: seq_len 0 row not zeros")
            check(torch.equal(out, multi1),
                  f"B5 k=1 != B4 bit for bit ({what})")
            check(torch.equal(out, again),
                  f"paged_decode {what} differs between two launches")
            rec = {"kernel": "paged_decode", "dtype": dtype, "lens": lens,
                   "page": page, "D": D,
                   "chunks": pa._decode_chunks(bt.shape[1], page),
                   "max_abs_err": err, "zeros_row_exact": True,
                   "b5_k1_bit_exact": True, "bit_deterministic": True}
            if (dtype, page, D) == ("bfloat16", 128, 64):
                nbytes, ops = paged_work(q, lens, 0)
                rec["ms"] = device_ms(lambda q, kp, vp: pa._paged_decode_cuda(
                    q, kp, vp, bt, sl, 1.0 / 8.0), q, kp, vp)
                rec["plain_ms"] = cuda_ms(lambda: pa.paged_attention_reference(
                    q, kp, vp, bt, sl), iters=10)
                rec["library_ms"] = None
                rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, dtype)
                lines["paged_decode"] = rec
            cases.append(rec)
    # ---- B5: k = 1, 8, 64 rows (64 = the suffix-prefill chunk); at k = 8
    # row r must equal a B4 step at seq_len - (k - 1 - r) bit for bit
    for dtype in ("bfloat16", "float32"):
        for K, lens5, q_rows in ((1, [300, 0, 45], None),
                                 (8, [129, 400, 8], None),
                                 (64, [320], [64]), (64, [300], [44])):
            q, kp, vp, bt, sl = paged_case(dev, dtype, lens5, K, gen)
            kr = (None if q_rows is None else
                  torch.tensor(q_rows, dtype=torch.int32, device=dev))
            out = pa._paged_decode_multi_cuda(q, kp, vp, bt, sl, kr, None,
                                              1.0 / 8.0, None)
            again = pa._paged_decode_multi_cuda(q, kp, vp, bt, sl, kr, None,
                                                1.0 / 8.0, None)
            ref = pa.paged_attention_reference(q, kp, vp, bt, sl, q_rows=kr)
            steps = ([pa._paged_decode_cuda(q[:, r].contiguous(), kp, vp, bt,
                                            sl - (K - 1 - r), 1.0 / 8.0)
                      for r in range(K)] if K == 8 else None)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            check(err <= TOL["paged"][dtype],
                  f"paged_decode_multi k={K} {dtype} err {err}")
            check(torch.equal(out, again), f"paged_decode_multi k={K} "
                                           f"{dtype} differs between two "
                                           "launches")
            rec = {"kernel": "paged_decode_multi", "dtype": dtype, "k": K,
                   "lens": lens5, "q_rows": q_rows, "max_abs_err": err,
                   "bit_deterministic": True}
            if steps is not None:
                bad = [r for r in range(K) if not torch.equal(out[:, r],
                                                              steps[r])]
                check(not bad, f"B5 k={K} {dtype}: rows {bad} != B4 at "
                               "seq_len - (k - 1 - r)")
                rec["rows_equal_b4_steps"] = True
            if (K, dtype, q_rows) == (64, "bfloat16", [64]):
                nbytes, ops = paged_work(q, lens5, K)
                rec["ms"] = device_ms(
                    lambda q, kp, vp: pa._paged_decode_multi_cuda(
                        q, kp, vp, bt, sl, kr, None, 1.0 / 8.0, None),
                    q, kp, vp)
                rec["plain_ms"] = cuda_ms(
                    lambda: pa.paged_attention_reference(
                        q, kp, vp, bt, sl, q_rows=kr), iters=5)
                rec["library_ms"] = None
                rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, dtype)
                lines["paged_decode_multi"] = rec
            cases.append(rec)
    cases += b5_window_cases(dev, gen, lines)
    cases += bwd_cases(dev, gen, lines)
    cases += bwd_edge_cases(dev, gen)
    cases += sched_cases(dev, gen)
    cases.append({"kernel": "flash_*_sched", "timed": time_sched(dev, gen,
                                                                 lines)})
    emit({"phase": "kernels", "cases": cases})
    return lines


# ------------------------------------------------------------ main paths


def decode_prompts(seed, vocab):
    """The decode path's traffic: 8 prompts of 100-400 random ids (the
    first at least 300 long) and a prompt sharing 256 tokens with the
    first (the prefix-hit prompt)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = [int(n) for n in rng.integers(100, 401, size=8)]
    lens[0] = max(lens[0], 300)          # the prefix-hit donor
    prompts = [[int(t) for t in rng.integers(0, vocab, size=n)]
               for n in lens]
    suffix = [int(t) for t in rng.integers(0, vocab, size=60)]
    return prompts, prompts[0][:256] + suffix


def decode_kwargs(dev, seed, new_tokens):
    return dict(preset="base", max_batch=8, num_pages=64,
                max_new_tokens=new_tokens, device=dev, seed=seed)


def encode_requests(seed, vocab):
    """The encode path's traffic: 8 requests of 30-500 random ids."""
    import numpy as np
    rng = np.random.default_rng(seed + 1)
    lens = [int(n) for n in rng.integers(30, 501, size=8)]
    return [{"ids": [int(t) for t in rng.integers(0, vocab, size=n)]}
            for n in lens]


def phase_decode(dev, seed, new_tokens):
    """Returns the path's launch counts and its streams (the direct
    streams the serve phase holds its served streams to)."""
    import torch
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    kw = decode_kwargs(dev, seed, new_tokens)
    be = BertDecodeBackend(**kw)
    prompts, hit_prompt = decode_prompts(seed, be.cfg.vocab_size)
    lens = [len(p) for p in prompts]
    # warm-up request (under one page, so it leaves no prefix entry):
    # first-call library set-up stays out of the timed admits
    be.call({"ids": prompts[1][:50], "max_new_tokens": 2})
    torch.cuda.synchronize()

    registry.reset_launch_counts()
    t0 = time.perf_counter()
    ttft = []
    for i, p in enumerate(prompts):
        a = time.perf_counter()
        out = be.admit(i, {"ids": p})
        ttft.append((time.perf_counter() - a) * 1e3)
        check(not out["done"], f"prompt {i} finished at admit")
    t_admit = time.perf_counter() - t0
    step = 0
    live = list(range(8))
    t1 = time.perf_counter()
    while live:
        outs = be.step_batch(live, [step] * len(live))
        for sid, o in zip(list(live), outs):
            check("token" in o, f"step {step} seq {sid}: {o}")
            if o["done"]:
                live.remove(sid)
        step += 1
    t_steps = time.perf_counter() - t1
    streams = [be.result(i)["generated"] for i in range(8)]
    for s in streams:
        check(len(s) == new_tokens, f"stream length {len(s)}")
    a = time.perf_counter()
    out = be.admit("hit", {"ids": hit_prompt})
    ttft_hit = (time.perf_counter() - a) * 1e3
    st = be.cache_stats()
    n = 0
    while not out["done"]:
        out = be.step_batch(["hit"], [n])[0]
        n += 1
    hit_stream = be.result("hit")["generated"]
    counts = dict(registry.LAUNCH_COUNTS)
    for name in ("flash_fwd", "paged_decode", "paged_decode_multi"):
        check(counts[name] > 0, f"{name} never launched on the decode path")
    check(st["prefix_hits"] >= 1, f"no prefix hit: {st}")

    cold = BertDecodeBackend(prefix_cache=False, **kw)
    cold_stream = cold.call({"ids": hit_prompt})["generated"]
    if hit_stream != cold_stream:
        emit({"phase": "decode", "prefix_hit_mismatch": logit_margin(
            cold.model, hit_prompt, cold_stream, hit_stream)})
    check(hit_stream == cold_stream,
          f"prefix-hit stream {hit_stream} != cold stream {cold_stream}")
    gen_tokens = 8 * (new_tokens - 1)
    figures = {"ttft_ms_mean": sum(ttft) / len(ttft),
               "decode_tokens_per_s": gen_tokens / t_steps,
               "ms_per_step": t_steps / step * 1e3}
    emit({"phase": "decode", "prompt_lens": lens,
          "ttft_ms": ttft, "admit_s": t_admit, "steps": step,
          "step_s": t_steps, **figures,
          "prefix_hit_ttft_ms": ttft_hit, "prefix_hits": st["prefix_hits"],
          "reused_tokens": st["reused_tokens"],
          "hit_equals_cold": True, "launches": counts,
          "stream0_head": streams[0][:8]})
    del be, cold
    torch.cuda.empty_cache()
    return counts, {"streams": streams, "hit_stream": hit_stream,
                    "figures": figures}


def logit_margin(model, prompt, stream, other):
    """Where two greedy streams of one prompt part: the first step that
    differs, and the top-1 minus top-2 logit margin there on ``model``
    (a cold prefill of the prompt and the common tokens). A margin within
    bf16 rounding of a tie points at rounding, a wide one at the cache."""
    import torch
    step = next((i for i, (a, b) in enumerate(zip(stream, other)) if a != b),
                min(len(stream), len(other)))
    ids = torch.as_tensor([prompt + stream[:step]], dtype=torch.int32,
                          device=model.device)
    lg, _, _ = model.prefill_fn()(ids, torch.ones_like(ids))
    top = torch.topk(lg[0, -1].float(), 2)
    return {"first_differing_step": step,
            "tokens": [stream[step:step + 1], other[step:step + 1]],
            "top2_ids": top.indices.tolist(),
            "top1_minus_top2": (top.values[0] - top.values[1]).item()}


# ------------------------------------------------------------ decode modes

WINDOW = 128        # the decode_modes phase's sliding window
SPEC_K = 4          # and its speculative block
# a mode's bf16 logits rows against greedy's (or a cold admit's) at the
# same positions, as a fraction of the largest logit: the cpu phase's
# bf16 limit (other GEMM shapes and kernels round each layer otherwise)
ROW_TOL = 2e-2


def base_params(seed):
    """BERT-base's weights as the parameter tree backends take as
    ``params=`` (nested dicts of fp32 numpy arrays), from the seeded init
    every other phase builds. A bf16 backend rounds them back to exactly
    the seed's bf16 weights; an fp32 one runs them as they are."""
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    tree = {}
    for name, t in Bert(BertConfig.base(), device="cpu",
                        seed=seed).state_dict().items():
        parts = name.split(".")
        if parts[0] == "layers":
            parts = [f"layer{parts[1]}"] + parts[2:]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.float().numpy()
    return tree


@contextlib.contextmanager
def fp32_base():
    """``preset="base"`` at float32: the backends build
    ``BertConfig.base()`` (bf16); inside this block they get a subclass
    whose default dtype is float32."""
    import dataclasses

    import tosem_tpu_torch.models.bert as mb
    bf16 = mb.BertConfig

    @dataclasses.dataclass(frozen=True)
    class BertConfig32(bf16):
        dtype: str = "float32"
    mb.BertConfig = BertConfig32
    try:
        yield
    finally:
        mb.BertConfig = bf16


def recording_decode():
    """``BertDecodeBackend`` keeping the logits rows it computes for each
    cache sequence: its prefill's last row, then its rows of each step
    (``rows``), and each with the tokens fed to reach it (``fed``: start
    position, tokens fed from there, their rows)."""
    import collections
    from tosem_tpu_torch.serve.backends import BertDecodeBackend

    class RecordingDecode(BertDecodeBackend):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.rows = collections.defaultdict(list)
            self.fed = collections.defaultdict(list)

        def _prefill_into_cache(self, seq_id, toks):
            row = super()._prefill_into_cache(seq_id, toks)
            self.rows[seq_id].append(row)
            self.fed[seq_id].append((len(toks) - 1, [toks[-1]], [row]))
            return row

        def _run_step(self, plans):
            out = super()._run_step(plans)
            for p, r in zip(plans, out):
                self.rows[p.cid].extend(r)
                self.fed[p.cid].append((p.start, list(p.fed), list(r)))
            return out
    return RecordingDecode


def rows_on(be, cid, ids, tag=None):
    """{(tag, position): logits row} of the rows a ``recording_decode``
    backend computed for cache sequence ``cid`` after tokens that lie on
    ``ids`` (a speculative step's rows past its first rejected draft do
    not). ``tag`` (default ``cid``) names the sequence in the keys."""
    tag = cid if tag is None else tag
    got = {}
    for start, fed, rows in be.fed[cid]:
        for j, row in enumerate(rows):
            if fed[:j + 1] != ids[start:start + j + 1]:
                break
            got.setdefault((tag, start + j), row)
    return got


def hold_rows(what, want, got, extra=None, exact=False,
              phase="decode_modes"):
    """Hold the logits rows ``got`` against ``want`` ({(sequence,
    position): row}) where both computed one (one side's keys must all
    be the other's): within ROW_TOL of the largest logit, or bit for bit
    when ``exact``. Yardstick:
    ``got`` against ``want``'s row one position later (earlier at its
    last) must break that limit at every position (a row written at the
    wrong offset), and so must each of ``extra``'s rows ({name: {key:
    row}}). Returns the record."""
    import numpy as np
    common = sorted(set(want) & set(got))
    check(common and len(common) == min(len(want), len(got)),
          f"{what}: rows at {sorted(got)} against {sorted(want)}")
    scale = max(float(np.abs(want[p]).max()) for p in common)
    limit = 0.0 if exact else ROW_TOL * max(1.0, scale)
    err = max(float(np.abs(got[p] - want[p]).max()) for p in common)
    off = [float(np.abs(got[i, p] - want[nb]).max())
           for i, p in common
           for nb in [(i, p + 1) if (i, p + 1) in want else (i, p - 1)]
           if nb in want]
    rec = {"positions": len(common), "max_abs_diff": err, "limit": limit,
           "exact": exact,
           "largest_logit": scale, "off_by_one_min": min(off),
           "off_by_one_max": max(off)}
    for name, rows in (extra or {}).items():
        rec[name] = min(float(np.abs(r - want[k]).max())
                        for k, r in rows.items())
    emit({"phase": phase, f"{what}_rows": rec})
    check(err <= limit, f"{what}: logits rows differ: {rec}")
    check(len(off) >= 1 and min(off) > limit,
          f"{what}: the rows check cannot see a row one position off: "
          f"{rec}")
    for name in extra or {}:
        check(rec[name] > limit, f"{what}: the rows check cannot see "
                                 f"{name}: {rec}")
    return rec


def decode_all(be, reqs, steps=None):
    """Admit ``reqs`` as sequences 0..n-1 and step them together until
    all are done (or for ``steps`` steps), then release them. Returns
    their results, ms a step (host clock), steps, tokens/s, committed
    tokens per (sequence, step), and the most pages a sequence (or a
    group's branch) held after its admit or any step."""
    import torch

    def held(live):
        cids = [c for s in live for c, _ in be._live_cids(s)]
        return max((len(be.cache.pages_of(c)) for c in cids), default=0)
    outs = [be.admit(i, r) for i, r in enumerate(reqs)]
    live = [i for i, o in enumerate(outs) if not o["done"]]
    most = held(live)
    if be.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = tokens = seq_steps = 0
    while live and (steps is None or step < steps):
        res = be.step_batch(live, [step] * len(live))
        for sid, o in zip(list(live), res):
            check("token" in o, f"step {step} seq {sid}: {o}")
            tokens += o.get("n_tokens", 1)
            seq_steps += 1
            if o["done"]:
                live.remove(sid)
        step += 1
        most = max(most, held(live))
    secs = time.perf_counter() - t0
    results = [be.result(i) for i in range(len(reqs))]
    for i in range(len(reqs)):
        be.release(i)
    return {"results": results, "ms_per_step": secs / max(step, 1) * 1e3,
            "steps": step, "tokens_per_s": tokens / secs if secs else 0.0,
            "tokens_per_seq_step": tokens / max(seq_steps, 1),
            "max_pages_per_seq": most}


def figures(run):
    return {k: v for k, v in run.items() if k != "results"}


def window_vs_cpu(dev, params, prompts, page, num_pages, plain_rows,
                  steps=8):
    """The windowed backend on the card and on the CPU, both fp32 with
    the same weights, over ``steps`` steps of two prompts longer than the
    window: every step's logits (and the prefill's) within 1e-3 of the
    largest logit, the tokens equal. ``plain_rows`` are the CPU's
    unwindowed rows of the same prompts: the yardstick that must break
    the same check."""
    import numpy as np
    Rec = recording_decode()
    kw = dict(preset="base", max_batch=8, page_size=page,
              num_pages=num_pages, max_new_tokens=steps + 1, params=params,
              window=WINDOW)
    with fp32_base():
        card, cpu = Rec(device=dev, **kw), Rec(device="cpu", **kw)
    reqs = [{"ids": p} for p in prompts]
    got = {name: decode_all(be, reqs)["results"]
           for name, be in (("card", card), ("cpu", cpu))}

    def gap(a, b):
        return max(float(np.abs(x - y).max()) for i in range(len(reqs))
                   for x, y in zip(a.rows[i], b[i]))
    cpu_rows = [cpu.rows[i] for i in range(len(reqs))]
    scale = max(float(np.abs(r).max()) for rows in cpu_rows for r in rows)
    limit = 1e-3 * max(1.0, scale)
    rec = {"page": page, "table_w": card.table_w,
           "max_pages": card.max_pages, "max_abs_diff": gap(card, cpu_rows),
           "unwindowed_yardstick": gap(card, plain_rows),
           "largest_logit": scale, "limit": limit,
           "rows_each": len(cpu_rows[0])}
    for i in range(len(reqs)):
        a, b = (got[n][i]["generated"] for n in ("card", "cpu"))
        if a != b:
            step = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            top = np.sort(cpu_rows[i][step])[-2:]
            rec.setdefault("mismatch", []).append(
                {"prompt": i, "first_differing_step": step,
                 "cpu_top1_minus_top2": float(top[1] - top[0])})
    emit({"phase": "decode_modes", "window_vs_cpu": rec})
    check(len(cpu_rows[0]) == steps + 1, f"{rec}")
    check("mismatch" not in rec, f"window card vs cpu tokens: {rec}")
    check(rec["max_abs_diff"] <= limit, f"window card vs cpu logits: {rec}")
    check(rec["unwindowed_yardstick"] > limit,
          f"the window check cannot see an unwindowed run: {rec}")
    return rec


def greedy_logprob(rows, stream):
    """Cumulative fp64 log-probability of a greedy stream from its rows
    (the prefill's last row, then one a step), as beams score theirs."""
    from tosem_tpu_torch.serve.backends import _log_softmax
    return sum(float(_log_softmax(r)[t]) for r, t in zip(rows, stream))


def first_parting_op(model, prompts, page=128, k=SPEC_K):
    """C6's probe: from one cache state, ``k`` greedy steps (8 rows of
    one token, B4) and one speculative step (8 rows of ``k`` tokens, B5)
    that feeds each sequence the tokens greedy chose, so speculative row
    r sees what greedy's step r sees. Hooks on every submodule record
    each call's input and output; in call order, greedy step r's row is
    held against speculative row r bit for bit. Returns, for each r, the
    first op that parts — a module whose input rows are equal and output
    rows are not, the code between two modules where a module's input
    parts after the previous output agreed, or the LM head after the
    last module (``tok.attend``, no module call) — with the logits gap,
    and the calls that part at r = 0 and r = 1."""
    import torch
    dev = model.device
    cfg = model.cfg
    B, L, H = len(prompts), cfg.layers, cfg.heads
    D = cfg.dim // H
    lens = [len(p) for p in prompts]
    per = [-(-(n + k) // page) for n in lens]
    dt = next(model.parameters()).dtype
    kp = torch.zeros(L, sum(per), page, H, D, dtype=dt, device=dev)
    vp = torch.zeros_like(kp)
    tables = torch.zeros(B, max(per), dtype=torch.int32, device=dev)
    prefill = model.prefill_fn()
    first, nxt = [], 0
    for b, prompt in enumerate(prompts):
        ids = torch.as_tensor([prompt], dtype=torch.int32, device=dev)
        lg, kk, vv = prefill(ids, torch.ones_like(ids))
        first.append(int(lg[0, -1].argmax()))
        for j in range(per[b]):
            tables[b, j] = nxt
            lo, hi = j * page, min(lens[b], (j + 1) * page)
            if lo < hi:
                kp[:, nxt, :hi - lo] = kk[:, 0, lo:hi].to(dt)
                vp[:, nxt, :hi - lo] = vv[:, 0, lo:hi].to(dt)
            nxt += 1
    n = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    calls = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, outp, name=name: calls[-1].append(
            (name, inp[0].detach(), outp.detach())))
        for name, m in model.named_modules() if name]
    try:
        step = model.decode_step_fn(page_size=page)
        kg, vg = kp.clone(), vp.clone()
        tok = torch.as_tensor(first, dtype=torch.int32, device=dev)
        fed, g_logits = [], []
        for r in range(k):
            calls.append([])
            fed.append(tok)
            lg, _, _ = step(tok, n + r, kg, vg, tables, n + r + 1)
            g_logits.append(lg)
            tok = lg.argmax(-1).to(torch.int32)
        calls.append([])
        multi = model.decode_multi_fn(page_size=page, q_tokens=k)
        pos = n[:, None] + torch.arange(k, dtype=torch.int32,
                                        device=dev)[None]
        s_logits, _, _ = multi(torch.stack(fed, 1), pos, kp.clone(),
                               vp.clone(), tables, n + k,
                               torch.full_like(n, k), torch.zeros_like(n))
    finally:
        for h in hooks:
            h.remove()
    spec = calls[-1]
    check(all([c[0] for c in g] == [c[0] for c in spec]
              for g in calls[:-1]),
          "C6 probe: the greedy and speculative steps call other modules")

    def gap(g, s, r):
        g = g.reshape(B, -1).float()
        s = s.reshape(B, k, -1)[:, r].float()
        return (g - s).abs().max().item()
    rows, parting = [], {}
    for r in range(k):
        first_op, prev_out, part = None, 0.0, []
        for (name, gi, go), (_, si, so) in zip(calls[r], spec):
            d_in, d_out = gap(gi, si, r), gap(go, so, r)
            if d_in > 0 or d_out > 0:
                part.append([name, d_in, d_out])
            if first_op is None and d_in > 0 and prev_out == 0:
                first_op = f"the code before {name} (its input parts)"
            if first_op is None and d_in == 0 and d_out > 0:
                first_op = name
            prev_out = d_out
        lg = gap(g_logits[r], s_logits, r)
        if first_op is None and lg > 0:
            first_op = "the LM head (tok.attend: fp32 GEMM of the rows)"
        rows.append({"row": r, "first_parting_op": first_op,
                     "logits_gap": lg, "calls_parting": len(part)})
        if r < 2:
            parting[r] = part[:8]
    # C6's two ops alone, each over the 8 rows as [8, dim] against the
    # same rows inside [8 * k, dim], as greedy and speculative steps
    # call them: the decode steps' LayerNorm (``LayerNorm.rows``) and LM
    # head (``Bert._head_rows``), beside the forms the probe first caught
    # (``LayerNorm.forward``'s plain fp32 ``mean``, which the encoder,
    # prefill and training keep, and one GEMM of all the rows)
    xs = torch.randn((B, k, cfg.dim), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev).to(dt)
    ln = model.layers[3].ln1
    forms = {"layernorm": ln.rows, "layernorm_plain_mean": ln,
             "head_rows": model._head_rows, "head_one_gemm": model._head}
    stats = {}
    with torch.no_grad():
        for what, f in forms.items():
            whole = f(xs)
            stats[f"{what}_rows_parting"] = sum(
                int(((f(xs[:, r].contiguous()) - whole[:, r]).abs()
                     .amax(-1) > 0).sum()) for r in range(k))
        # the repair's cost: device ms of each form at 8 and 32 rows
        cost = {f"{what}_ms_{n}_rows": device_ms(f, xs.reshape(-1, cfg.dim)
                                                 [:n].contiguous())
                for what, f in forms.items() for n in (B, B * k)}
    # a step runs 2 LayerNorms a layer and ln_emb (and ln_out in the
    # head), and one head: what the repair adds to a step of 8 and of 32
    for n, what in ((B, "greedy"), (B * k, "spec")):
        cost[f"{what}_step_ms_added"] = (
            (2 * L + 1) * (cost[f"layernorm_ms_{n}_rows"]
                           - cost[f"layernorm_plain_mean_ms_{n}_rows"])
            + cost[f"head_rows_ms_{n}_rows"]
            - cost[f"head_one_gemm_ms_{n}_rows"])
    return {"rows": rows, "calls": len(spec),
            "largest_logit": max(x.float().abs().max().item()
                                 for x in g_logits),
            "parting": parting, "ops_8_vs_32_rows": stats,
            "repair_cost": cost}


def phase_decode_modes(dev, seed, new_tokens, direct=None):
    """BERT-base (bf16, page 128) in every decode mode, each backend
    loading the same weights (``params=``): sliding window (card against
    the CPU in fp32 at page 128 and 16, the pages held, a window longer
    than the history), speculative decode (alone and with a window),
    beam and sampling groups, a session's second turn, and spill/restore
    and export/import at step 10. ``direct`` carries the decode phase's
    greedy streams when it ran. Returns the kernels' launch counts."""
    import numpy as np
    import torch
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    t_phase = time.perf_counter()
    params = base_params(seed)
    kw = dict(preset="base", max_batch=8, num_pages=64,
              max_new_tokens=new_tokens, device=dev, params=params)
    prompts, hit_prompt = decode_prompts(seed, 30522)
    reqs = [{"ids": p} for p in prompts]
    out = {"phase": "decode_modes", "gpu": gpu_line(), "window": WINDOW,
           "spec_k": SPEC_K, "launches": {}}
    counts = {k: 0 for k in KERNELS}

    def launched(name, need):
        c = dict(registry.LAUNCH_COUNTS)
        for k in need:
            check(c[k] > 0, f"{k} never launched in the {name} run")
        for k in counts:
            counts[k] += c[k]
        out["launches"][name] = {k: v for k, v in c.items() if v}
        registry.reset_launch_counts()

    def same_streams(what, want, got, model, prompt_of):
        for i, (w, g) in enumerate(zip(want, got)):
            if w != g:
                emit({"phase": "decode_modes", f"{what}_mismatch": {
                    "prompt": i, **logit_margin(model, prompt_of(i), w, g)}})
            check(w == g, f"{what}: prompt {i} stream {g} != {w}")

    # greedy: the streams every mode is held to, and the beams' yardstick
    Rec = recording_decode()
    greedy_be = Rec(**kw)
    registry.reset_launch_counts()
    greedy = decode_all(greedy_be, reqs)
    launched("greedy", ("flash_fwd", "paged_decode"))
    g_streams = [r["generated"] for r in greedy["results"]]
    if direct is not None:
        check(g_streams == direct["streams"],
              "greedy streams from params= differ from the decode phase's")
    g_score = {i: greedy_logprob(greedy_be.rows[i], g_streams[i])
               for i in (2, 3)}
    # each mode's logits rows are held to greedy's at the same positions:
    # with random weights a stream repeats one token, so equal tokens
    # alone would hide a wrong row
    seq_ids = [p + g for p, g in zip(prompts, g_streams)]
    g_rows = {k: r for i, ids in enumerate(seq_ids)
              for k, r in rows_on(greedy_be, i, ids).items()}
    out["rows"] = {}

    def rows_of(be, seqs=range(8)):
        return {k: r for i in seqs
                for k, r in rows_on(be, i, seq_ids[i]).items()}
    model = greedy_be.model
    out["greedy"] = figures(greedy)

    # (a) window: pages, eviction, launches; card vs CPU; W >= history
    win_be = BertDecodeBackend(window=WINDOW, **kw)
    win = decode_all(win_be, reqs)
    launched("window", ("paged_decode_multi", "flash_fwd_sched"))
    bound_pages = -(-WINDOW // win_be.page_size) + 2
    st = win_be.cache.stats()
    out["window_run"] = {**figures(win), "page_bound": bound_pages,
                         "pages_evicted_total": st["pages_evicted_total"],
                         "pages_used_after_release": st["pages_used"]}
    check(win["max_pages_per_seq"] <= bound_pages,
          f"a windowed sequence held {win['max_pages_per_seq']} pages")
    check(st["pages_evicted_total"] > 0, f"no page evicted: {st}")
    check(st["pages_used"] == 0, f"pages left after release: {st}")
    w_streams = [r["generated"] for r in win["results"]]
    del win_be
    # the card against the CPU on two prompts of at least 300 tokens: the
    # first prompt and the prefix-hit prompt (256 of its tokens + 60)
    long2 = [prompts[0], hit_prompt]
    check(min(map(len, long2)) >= 300, "a long prompt under 300 tokens")
    with fp32_base():
        plain = Rec(preset="base", max_batch=8, num_pages=64,
                    max_new_tokens=9, params=params, device="cpu")
    decode_all(plain, [{"ids": p} for p in long2])
    plain_rows = [plain.rows[i] for i in range(2)]
    del plain
    out["window_vs_cpu"] = [
        window_vs_cpu(dev, params, long2, page, pages, plain_rows)
        for page, pages in ((128, 64), (16, 256))]
    launched("window_fp32", ("paged_decode_multi", "flash_fwd_sched"))
    full_be = Rec(window=512, **kw)
    full = decode_all(full_be, reqs)
    launched("window_512", ("paged_decode_multi", "flash_fwd_sched"))
    same_streams("window_512", g_streams,
                 [r["generated"] for r in full["results"]], model,
                 lambda i: prompts[i])
    out["rows"]["window_512"] = hold_rows("window_512", g_rows,
                                          rows_of(full_be))
    out["window_512"] = figures(full)
    del full_be

    # (b) speculative, alone and under the window
    spec_be = Rec(spec_k=SPEC_K, **kw)
    spec = decode_all(spec_be, reqs)
    launched("spec", ("paged_decode_multi",))
    sst = spec_be.cache_stats()
    out["spec"] = {**figures(spec), "spec_proposed": sst["spec_proposed"],
                   "spec_accepted": sst["spec_accepted"],
                   "acceptance": sst["spec_accepted"]
                   / max(sst["spec_proposed"], 1)}
    emit({"phase": "decode_modes", "spec": out["spec"]})
    same_streams("spec", g_streams,
                 [r["generated"] for r in spec["results"]], model,
                 lambda i: prompts[i])
    # C6: which op, if any, makes a speculative row part from greedy's
    out["c6_probe"] = first_parting_op(model, prompts)
    emit({"phase": "decode_modes", "c6_probe": out["c6_probe"]})
    registry.reset_launch_counts()
    parted = out["c6_probe"]["ops_8_vs_32_rows"]
    check(parted["layernorm_rows_parting"] == 0
          and parted["head_rows_rows_parting"] == 0,
          f"C6 probe: a repaired op gives a row other bits among 8 rows "
          f"than among 32: {parted}")
    # the North star's pin: speculative rows are greedy's, bit for bit
    out["rows"]["spec"] = hold_rows("spec", g_rows, rows_of(spec_be),
                                    exact=True)
    check(sst["spec_accepted"] > 0, f"no draft accepted: {sst}")
    check(spec["tokens_per_seq_step"] > 1.0,
          f"{spec['tokens_per_seq_step']} tokens a step")
    del spec_be
    ws_be = BertDecodeBackend(window=WINDOW, spec_k=SPEC_K, **kw)
    ws = decode_all(ws_be, reqs)
    launched("window_spec", ("paged_decode_multi", "flash_fwd_sched"))
    same_streams("window_spec", w_streams,
                 [r["generated"] for r in ws["results"]], model,
                 lambda i: prompts[i])
    out["window_spec"] = figures(ws)
    del ws_be

    # (c) groups: two beam groups of 4 in one batch of 8 rows; sampling
    grp = BertDecodeBackend(prefix_cache=False, **kw)
    used0 = grp.cache.stats()["pages_used"]
    beam_reqs = [{"ids": prompts[i], "n": 4, "beam": True} for i in (2, 3)]
    first = grp.admit("probe", beam_reqs[0])
    group_pages = grp.cache.stats()["pages_used"] - used0
    single_pages = -(-len(prompts[2]) // grp.page_size)
    grp.release("probe")
    check(not first["done"] and group_pages <= 1.5 * single_pages,
          f"a group of 4 took {group_pages} pages at admit, one sequence "
          f"{single_pages}")
    beams = decode_all(grp, beam_reqs)
    launched("beam", ("flash_fwd", "paged_decode"))
    best = {}
    for (i, res) in zip((2, 3), beams["results"]):
        lps = [e["logprob"] for e in res["beams"]]
        check(len(lps) == 4 and lps == sorted(lps, reverse=True),
              f"beams of prompt {i} not sorted: {lps}")
        best[i] = lps[0]
        check(lps[0] >= g_score[i] - 1e-6,
              f"best beam {lps[0]} below greedy {g_score[i]} (prompt {i})")
    samp = {"ids": prompts[4], "n": 4, "temperature": 0.8, "seed": 7}
    alone = [decode_all(grp, [samp])["results"][0] for _ in range(2)]
    packed = decode_all(grp, [{"ids": prompts[5]}, samp])["results"][1]
    launched("sampling", ("flash_fwd", "paged_decode"))
    draws = [[e["tokens"] for e in r["samples"]]
             for r in alone + [packed]]
    check(draws[0] == draws[1], "two sampling runs differ")
    check(draws[2] == draws[0], "sampling packed beside other traffic "
                                "differs from the run alone")
    out["groups"] = {"beam": figures(beams), "best_beam_logprob": best,
                     "greedy_logprob": g_score,
                     "group_pages_at_admit": group_pages,
                     "single_pages": single_pages}
    del grp

    # (d) session: turn 2 = turn 1's history + 50 new ids
    ses = Rec(**kw)
    hist = decode_all(ses, [{"ids": prompts[1], "session": "chat"}])[
        "results"][0]["tokens"]
    more = np.random.default_rng(seed + 3).integers(0, 30522, 50)
    ids2 = hist + [int(t) for t in more]
    before = ses.cache_stats()
    turn2 = decode_all(ses, [{"ids": ids2, "session": "chat"}])
    after = ses.cache_stats()
    launched("session", ("paged_decode", "paged_decode_multi"))
    cold = Rec(prefix_cache=False, **kw)
    cold_stream = cold.call({"ids": ids2})["generated"]
    prefilled = after["prefill_tokens"] - before["prefill_tokens"]
    out["session"] = {**figures(turn2), "turn2_len": len(ids2),
                      "prefilled_tokens": prefilled,
                      "session_hits": after["session_hits"]}
    check(after["session_hits"] == before["session_hits"] + 1,
          f"no session hit: {after}")
    check(prefilled == len(ids2) - (len(hist) - 1),
          f"turn 2 prefilled {prefilled} tokens")
    same_streams("session", [cold_stream],
                 [turn2["results"][0]["generated"]], cold.model,
                 lambda i: ids2)
    # turn 2's rows from the suffix's last position on (turn 1's and the
    # suffix's earlier rows have no cold counterpart)
    ids2_all = ids2 + cold_stream
    cold_cid = next(iter(cold.fed))
    out["rows"]["session"] = hold_rows(
        "session", rows_on(cold, cold_cid, ids2_all, tag=0),
        {k: r for k, r in rows_on(ses, 0, ids2_all).items()
         if k[1] >= len(ids2) - 1})
    registry.reset_launch_counts()
    del ses, cold

    # (e) spill/restore and export/import at step 10
    src = Rec(prefix_cache=False, **kw)
    dst = Rec(prefix_cache=False, **kw)
    for i in (0, 1):
        src.admit(i, reqs[i])
    for step in range(10):
        src.step_batch([0, 1], [step, step])
    pages = src.cache.pages_of(0)
    kb, vb = (p[:, pages].clone() for p in (src.cache.k_pool,
                                            src.cache.v_pool))
    torch.cuda.synchronize()
    t = time.perf_counter()
    src.spill_seq(0)
    spill_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    src.restore_seq(0)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t) * 1e3
    pages = src.cache.pages_of(0)
    check(torch.equal(kb, src.cache.k_pool[:, pages])
          and torch.equal(vb, src.cache.v_pool[:, pages]),
          "restored pages differ from the spilled ones")
    t = time.perf_counter()
    state = src.export_seq(1)
    export_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    dst.import_seq(1, state)
    torch.cuda.synchronize()
    import_ms = (time.perf_counter() - t) * 1e3
    src.release(1)
    # yardstick: the same state with its pages zeroed, imported beside
    # it, one step
    zeroed = dict(state, kv={k: (np.zeros_like(v) if k in ("k", "v")
                                 else v) for k, v in state["kv"].items()})
    dst.import_seq("zeroed", zeroed)
    dst.step_batch(["zeroed"], [10])
    zero_rows = {(1, p): r for (_, p), r in
                 rows_on(dst, "zeroed", seq_ids[1]).items()}
    dst.release("zeroed")
    for be, sid in ((src, 0), (dst, 1)):
        step, o = 10, {"done": False}
        while not o["done"]:
            o = be.step_batch([sid], [step])[0]
            step += 1
    moved = [src.result(0)["generated"], dst.result(1)["generated"]]
    payload_mb = (state["kv"]["k"].nbytes + state["kv"]["v"].nbytes) / 1e6
    out["spill_migrate"] = {
        "spill_ms": spill_ms, "restore_ms": restore_ms,
        "export_ms": export_ms, "import_ms": import_ms,
        "payload_mb": payload_mb, "pages": len(pages),
        "spill_payload_mb": (kb.nbytes + vb.nbytes) / 1e6}
    same_streams("spill_restore", g_streams[:1], moved[:1], model,
                 lambda i: prompts[i])
    same_streams("export_import", g_streams[1:2], moved[1:], model,
                 lambda i: prompts[1])
    out["rows"]["spill_restore"] = hold_rows(
        "spill_restore", {k: r for k, r in g_rows.items() if k[0] == 0},
        rows_of(src, (0,)))
    out["rows"]["export_import"] = hold_rows(
        "export_import", {k: r for k, r in g_rows.items() if k[0] == 1},
        rows_of(dst, (1,)), extra={"zeroed_pages": zero_rows})
    launched("spill_migrate", ("paged_decode",))
    del src, dst, greedy_be
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return counts


def phase_encode(dev, seed):
    import numpy as np
    import torch
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.serve.backends import BertEncodeBackend
    be = BertEncodeBackend(preset="base", max_batch=8, device=dev,
                           seed=seed)
    reqs = encode_requests(seed, be.cfg.vocab_size)
    lens = [len(r["ids"]) for r in reqs]
    be.call_batch(reqs)          # first call: cuBLAS and allocator set-up
    torch.cuda.synchronize()
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    outs = be.call_batch(reqs)
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(registry.LAUNCH_COUNTS)
    check(counts["flash_fwd"] > 0, "flash_fwd never launched on encode")
    for r, n in zip(outs, lens):
        check(r["len"] == n and r["pooled"].shape == (be.cfg.dim,)
              and np.isfinite(r["pooled"]).all(), f"bad encoding {r}")
    emit({"phase": "encode", "lens": lens, "batch_ms": ms,
          "flash_launches": counts["flash_fwd"], "launches": counts})
    del be
    torch.cuda.empty_cache()
    return counts


SERVE_BUCKETS = [128, 256, 384, 512]   # the prompt buckets at page 128
SERVE_GAUGES = ("serve_decode_active_sequences",
                "serve_decode_batch_occupancy", "serve_kv_pages")


def reset_counts():
    """Set the kernels' launch counts and the flash dispatch tally to 0:
    the last thing a replica's warm-up does."""
    from tosem_tpu_torch.nn.attention import FLASH_DISPATCH_COUNTS
    from tosem_tpu_torch.ops import registry
    registry.reset_launch_counts()
    FLASH_DISPATCH_COUNTS.clear()
    FLASH_DISPATCH_COUNTS.update({"flash": 0, "dense": 0})


def replica_stats(out):
    """``out`` with the kernels' launch counts and the process id, read
    inside the replica."""
    from tosem_tpu_torch.ops import registry
    out["launch_counts"] = dict(registry.LAUNCH_COUNTS)
    out["pid"] = os.getpid()
    return out


def replica_classes():
    """The two BERT backends as the serve phase deploys them: each
    subclass adds, to what ``stats()`` returns, what the phase reads from
    inside its replica process (the kernels' launch counts, the flash
    dispatch tally, the process id, and the replica's own time in each
    admit, step and micro-batch, so the phase can tell the control
    plane's time from the backend's), and runs
    each declared bucket once on the card in ``warmup`` (the backends'
    own ``warmup`` builds the step callables only), so deploy pays the
    replica's library set-up and its first request does not. The counts
    are set to 0 as warmup ends, the last thing deploy does. Defined in
    a function, so cloudpickle ships the classes by value to the spawned
    replicas; their bases come from the package."""
    from tosem_tpu_torch.serve.backends import (BertDecodeBackend,
                                                BertEncodeBackend)

    class ServedDecode(BertDecodeBackend):
        def admit(self, seq_id, request, *args, **kw):
            t = time.perf_counter()
            try:
                return super().admit(seq_id, request, *args, **kw)
            finally:
                if hasattr(self, "admit_ms"):
                    self.admit_ms.append((time.perf_counter() - t) * 1e3)

        def step_batch(self, seq_ids, step_idxs):
            t = time.perf_counter()
            try:
                return super().step_batch(seq_ids, step_idxs)
            finally:
                if hasattr(self, "step_ms"):
                    self.step_ms.append((time.perf_counter() - t) * 1e3)

        def warmup(self, shapes):
            import torch
            out = super().warmup(shapes)
            dev = self.device
            i32 = dict(dtype=torch.int32, device=dev)
            pools = (self.cache.k_pool, self.cache.v_pool)
            # the cached steps as a request runs them, page writes
            # included, into page 0: nothing is allocated yet, and every
            # slot is written by the sequence that owns it before it is
            # read, so the warm-up's writes are never seen
            for pad_to in shapes:
                ids = torch.zeros((1, pad_to), **i32)
                pos = torch.arange(pad_to, device=dev)
                self._prefill_compiled(pad_to)(
                    ids, torch.ones_like(ids), *pools,
                    torch.zeros_like(pos), pos % self.page_size)
            rows = torch.zeros((self.max_batch,), **i32)
            self._step_compiled()(
                rows, rows, *pools,
                torch.zeros((self.max_batch, self.max_pages), **i32), rows)
            if self._prefix is not None:
                q = self.suffix_q
                self._suffix_compiled()(
                    torch.zeros((1, q), **i32),
                    torch.arange(q, **i32)[None], *pools,
                    torch.zeros((1, self.max_pages), **i32),
                    torch.full((1,), q, **i32), torch.full((1,), q, **i32),
                    torch.zeros((1,), **i32))
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            reset_counts()
            self.admit_ms, self.step_ms = [], []
            return out

        def stats(self):
            out = replica_stats(super().stats())
            out["admit_ms"] = list(getattr(self, "admit_ms", []))
            out["step_ms"] = list(getattr(self, "step_ms", []))
            return out

    class ServedEncode(BertEncodeBackend):
        def warmup(self, shapes):
            import torch
            out = super().warmup(shapes)
            for pad_to in shapes:
                self.call_batch([{"ids": [0]}], pad_to=pad_to)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            reset_counts()
            self.batches = []
            return out

        def call_batch(self, requests, pad_to=None):
            t = time.perf_counter()
            out = super().call_batch(requests, pad_to=pad_to)
            if hasattr(self, "batches"):
                self.batches.append([len(requests), pad_to,
                                     (time.perf_counter() - t) * 1e3])
            return out

        def stats(self):
            out = replica_stats(super().stats())
            out["batches"] = list(getattr(self, "batches", []))
            return out

    return ServedDecode, ServedEncode


def open_connection(url):
    """An HTTP connection to ``url``'s host, connected now."""
    import http.client
    import urllib.parse
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    conn.connect()
    return conn


def stream_post(url, payload, t_start, conn=None):
    """POST one streamed decode and read its chunks as they arrive:
    (seconds from ``t_start`` to the first chunk and to the end, the
    streamed tokens, the final result). ``conn`` is a connection opened
    beforehand (:func:`open_connection`); None opens one now."""
    import urllib.parse
    u = urllib.parse.urlsplit(url)
    if conn is None:
        conn = open_connection(url)
    first, tokens, result = None, [], None
    try:
        conn.request("POST", u.path + (f"?{u.query}" if u.query else ""),
                     body=json.dumps(payload).encode(),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        check(r.status == 200, f"POST {url}: {r.status}")
        for line in r:
            if first is None:
                first = time.perf_counter() - t_start
            msg = json.loads(line)
            check("error" not in msg, f"POST {url}: {msg}")
            if "result" in msg:
                result = msg["result"]
            else:
                tokens.extend(msg["tokens"])
    finally:
        conn.close()
    check(result is not None, f"POST {url}: the stream ended without a "
          "result")
    return first, time.perf_counter() - t_start, tokens, result


# between two connections opened ahead of a release: the ingress'
# accept loop (a selector) takes each off its listen queue long before
# the next arrives
CONNECT_GAP_S = 0.02


def post_at_once(url, prompts):
    """Stream one decode of each prompt, all released together from one
    client thread each; returns each one's :func:`stream_post` result.
    The connections are opened one at a time before the release: the
    ingress listens with the reference's backlog of 5 (C-ref6), and 8
    connections made at once can leave two waiting out TCP's 1 s
    retransmit, so the requests would not reach the replicas together.
    An accepted connection is off the listen queue, so the 8 requests
    released at once arrive at once. Times run from the release."""
    import threading
    conns = []
    for _ in prompts:
        conns.append(open_connection(url))
        time.sleep(CONNECT_GAP_S)
    got = [None] * len(prompts)
    errors = []
    gate = threading.Barrier(len(prompts) + 1)
    t_send = [0.0]

    def client(i):
        try:
            gate.wait()
            got[i] = stream_post(url, {"ids": prompts[i]}, t_send[0],
                                 conns[i])
        except BaseException as e:
            errors.append(f"prompt {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for th in threads:
        th.start()
    t_send[0] = time.perf_counter()
    gate.wait()
    for th in threads:
        th.join()
    check(not errors, "; ".join(errors))
    return got


def pid_state(pid):
    """'gone', 'zombie' (exited, resources freed) or 'alive'."""
    try:
        with open(f"/proc/{pid}/status") as f:
            state = next(ln for ln in f if ln.startswith("State:"))
    except (FileNotFoundError, StopIteration):
        return "gone"
    return "zombie" if "Z" in state.split()[1] else "alive"


def phase_serve(dev, seed, new_tokens, direct=None):
    """BERT-base served from replica processes through the control
    plane: ``Serve`` deploys a decode backend behind ``DecodeQueue``
    (continuous batching) and an encode backend behind ``BatchQueue``
    (micro-batches in padding buckets); 8 streamed decodes arrive at once
    over ``HttpIngress``, then the prefix-hit prompt, then 8 encodes
    through a handle; then the 8 decodes again, at once, to a
    disaggregated deployment (a prefill replica streaming each sequence to
    a decode replica of 16 pages, which must spill), and the transfer leg
    (:func:`transfer_leg`). ``direct``
    carries the decode phase's streams when it ran. Returns the kernels'
    launch counts read inside the replicas."""
    import threading
    import urllib.request
    import numpy as np
    import torch
    import tosem_tpu_torch.runtime as rt
    from tosem_tpu_torch.obs.metrics import prometheus_text
    from tosem_tpu_torch.serve import (BertDecodeBackend, BertEncodeBackend,
                                       DecodePolicy, HttpIngress, Serve)
    from tosem_tpu_torch.serve.breaker import CLOSED
    from tosem_tpu_torch.models.bert import BertConfig
    ServedDecode, ServedEncode = replica_classes()
    vocab = BertConfig.base().vocab_size
    prompts, hit_prompt = decode_prompts(seed, vocab)
    reqs = encode_requests(seed, vocab)
    kw = decode_kwargs(dev, seed, new_tokens)
    torch.cuda.synchronize()
    free_before = torch.cuda.mem_get_info()[0]
    out = {"phase": "serve", "gpu": gpu_line()}
    pids = []
    t0 = time.perf_counter()
    serve = Serve()
    ingress = None
    try:
        out["runtime_init_s"] = time.perf_counter() - t0
        t = time.perf_counter()
        dec = serve.deploy(
            "decode", ServedDecode, init_kwargs=kw,
            decode_policy=DecodePolicy(max_active=8), circuit_breaker=True,
            warmup_shapes=SERVE_BUCKETS)
        out["decode_deploy_s"] = time.perf_counter() - t
        t = time.perf_counter()
        enc = serve.deploy(
            "encode", ServedEncode,
            init_kwargs=dict(preset="base", max_batch=8, seed=seed,
                             device=dev),
            max_batch_size=8, batch_wait_ms=10.0, buckets=SERVE_BUCKETS,
            length_of=BertEncodeBackend.length_of,
            warmup_shapes=SERVE_BUCKETS)
        out["encode_deploy_s"] = time.perf_counter() - t
        ingress = HttpIngress(serve)
        url = f"{ingress.url}/decode?stream=1"
        # the client's first request builds urllib's opener (CA store
        # included): keep that out of the timed requests
        with urllib.request.urlopen(f"{ingress.url}/-/routes",
                                    timeout=30) as r:
            check(sorted(json.loads(r.read())["routes"])
                  == ["decode", "encode"], "ingress routes")

        # 8 streamed decodes released together from 8 client threads
        got = post_at_once(url, prompts)
        ttft = [g[0] * 1e3 for g in got]
        t_end = max(g[1] for g in got)
        # a stream gets one chunk a scheduler step while it is active, so
        # its chunks' spacing is the served step time, whatever the
        # other streams' arrival (a step always runs max_batch rows)
        step_ms = [(g[1] - g[0]) / (new_tokens - 1) * 1e3 for g in got]
        steps8 = dec.stats()["decode_steps"]
        for i, (_, _, toks, res) in enumerate(got):
            check(toks == res["generated"], f"prompt {i}: streamed "
                  f"{toks} != result {res['generated']}")
            check(len(toks) == new_tokens, f"prompt {i}: {len(toks)} "
                  "tokens")
        t = time.perf_counter()
        hit = stream_post(url, {"ids": hit_prompt}, t)
        out["decode"] = {
            "ttft_ms": ttft, "ttft_ms_p50": float(np.median(ttft)),
            "ttft_ms_max": max(ttft), "end_s": t_end, "steps": steps8,
            "tokens_per_s_end_to_end": 8 * new_tokens / t_end,
            "stream_ms_per_step": step_ms,
            "ms_per_step": float(np.median(step_ms)),
            "decode_tokens_per_s": 8e3 / float(np.median(step_ms)),
            "prefix_hit_ttft_ms": hit[0] * 1e3}
        dec_replica = rt.get(dec._replicas[0].stats.remote(), timeout=60)
        pids.append(dec_replica["pid"])
        dstats = dec.stats()
        out["decode"].update(
            {k: dstats[k] for k in ("decode_steps", "tokens_emitted",
                                    "sequences_ok", "sequences_err")})
        out["decode"]["prefix_hits"] = dec_replica["prefix_hits"]
        out["decode"]["reused_tokens"] = dec_replica["reused_tokens"]
        # the replica's own time: what the control plane adds is the rest
        steps = dec_replica["step_ms"]
        out["decode"]["replica_admit_ms"] = dec_replica["admit_ms"]
        out["decode"]["replica_step_ms_median"] = float(np.median(steps))
        out["decode"]["replica_steps"] = len(steps)
        if direct is not None:
            out["decode"]["direct"] = direct["figures"]

        # 8 encodes through the handle, at once
        h = serve.get_handle("encode")
        done_at = [None] * 8
        t = time.perf_counter()
        futs = [h.remote(r) for r in reqs]

        def waiter(i):
            futs[i].result(timeout=300)
            done_at[i] = (time.perf_counter() - t) * 1e3

        waiters = [threading.Thread(target=waiter, args=(i,))
                   for i in range(8)]
        for th in waiters:
            th.start()
        for th in waiters:
            th.join()
        served = [f.result(timeout=1) for f in futs]
        enc_replica = rt.get(enc._replicas[0].stats.remote(), timeout=60)
        pids.append(enc_replica["pid"])
        out["encode"] = {"lens": [len(r["ids"]) for r in reqs],
                         "latency_ms": done_at,
                         "batches": enc_replica["batches"],
                         "queue": {k: enc.stats()[k] for k in
                                   ("batches", "requests_ok",
                                    "requests_err")}}

        # disaggregated prefill by export: a prefill replica and a decode
        # replica of 16 pages, which the 8 prompts (up to 4 pages each)
        # overflow, so the queue spills and restores as they grow
        t = time.perf_counter()
        dis = serve.deploy(
            "decode-disagg", ServedDecode, init_kwargs=dict(kw, num_pages=16),
            num_replicas=2,
            decode_policy=DecodePolicy(max_active=8, prefill_replicas=1),
            warmup_shapes=SERVE_BUCKETS)
        out["disagg_deploy_s"] = time.perf_counter() - t
        t = time.perf_counter()
        got_dis = post_at_once(f"{ingress.url}/decode-disagg?stream=1",
                               prompts)
        dis_reps = [rt.get(r.stats.remote(), timeout=60)
                    for r in dis._replicas]
        pids += [r["pid"] for r in dis_reps]
        dis_stats = dis.stats()
        out["disagg"] = {
            "end_s": max(g[1] for g in got_dis),
            "ttft_ms": [g[0] * 1e3 for g in got_dis],
            "tokens_per_s_end_to_end": 8 * new_tokens
            / max(g[1] for g in got_dis),
            **{k: dis_stats[k] for k in (
                "decode_steps", "sequences_ok", "sequences_err",
                "kv_spills", "kv_restores", "kv_migrations",
                "kv_migration_fallbacks", "seqs_readmitted_step0")},
            "replica_admit_ms": [r["admit_ms"] for r in dis_reps],
            "handoffs": {route: sum(r[f"handoffs_{route}"]
                                    for r in dis_reps)
                         for route in ("sent", "adopted", "exported")},
            "launches": [r["launch_counts"] for r in dis_reps]}

        # deployment state, the ingress' stats and the decode gauges
        with urllib.request.urlopen(f"{ingress.url}/-/stats",
                                    timeout=30) as r:
            stats_code = r.status
            body = json.loads(r.read())
        text = prometheus_text()
        out["breaker"] = dec.breaker.state
        out["launches"] = {"decode": dec_replica["launch_counts"],
                           "encode": enc_replica["launch_counts"]}
        out["flash_dispatch_encode"] = enc_replica["flash_dispatch"]
    finally:
        if ingress is not None:
            ingress.shutdown()
        for name in serve.list_deployments():
            serve.delete(name)
        rt.shutdown()

    # no replica process may be left holding the card
    deadline = time.perf_counter() + 30
    while time.perf_counter() < deadline and any(
            pid_state(p) == "alive" for p in pids):
        time.sleep(0.2)
    torch.cuda.synchronize()
    free_after = torch.cuda.mem_get_info()[0]
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    out["shutdown"] = {"replica_pids": {p: pid_state(p) for p in pids},
                       "compute_apps": apps,
                       "free_gib_before": free_before / 2**30,
                       "free_gib_after": free_after / 2**30}
    emit(out)

    # the checks, each of which fails the run
    for p in pids:
        check(pid_state(p) != "alive", f"replica {p} outlived shutdown")
        check(not any(a.split(",")[0].strip() == str(p) for a in apps),
              f"replica {p} still holds the card: {apps}")
    check(free_after >= free_before - (256 << 20),
          f"{(free_before - free_after) / 2**20:.0f} MiB of device memory "
          "not returned after shutdown")
    if direct is None:
        be = BertDecodeBackend(**kw)
        streams = [be.call({"ids": p})["generated"] for p in prompts]
        del be
        cold = BertDecodeBackend(prefix_cache=False, **kw)
        cold_hit = cold.call({"ids": hit_prompt})["generated"]
        del cold
    else:
        streams, cold_hit = direct["streams"], direct["hit_stream"]
    for i, g in enumerate(got):
        check(g[3]["generated"] == streams[i],
              f"served stream {i} {g[3]['generated']} != direct "
              f"{streams[i]}")
    if hit[3]["generated"] != cold_hit:
        from tosem_tpu_torch.models.bert import Bert
        model = Bert(BertConfig.base(), device=dev, seed=seed)
        emit({"phase": "serve", "prefix_hit_mismatch": logit_margin(
            model, hit_prompt, cold_hit, hit[3]["generated"])})
    check(hit[3]["generated"] == cold_hit,
          f"served prefix-hit stream {hit[3]['generated']} != cold "
          f"stream {cold_hit}")
    check(dec_replica["prefix_hits"] >= 1,
          f"no prefix hit in the replica: {dec_replica}")
    direct_enc = BertEncodeBackend(preset="base", max_batch=8, seed=seed,
                                   device=dev)
    for i, (r, got_enc) in enumerate(zip(reqs, served)):
        want = direct_enc.call(r)
        check(got_enc["len"] == want["len"]
              and np.array_equal(got_enc["pooled"], want["pooled"]),
              f"served encode {i} != direct call (max |diff| "
              f"{np.abs(got_enc['pooled'] - want['pooled']).max()})")
    del direct_enc
    torch.cuda.empty_cache()
    xfer = transfer_leg(dev, seed, new_tokens, prompts, hit_prompt, cold_hit)
    dl, el = out["launches"]["decode"], out["launches"]["encode"]
    for name in ("flash_fwd", "paged_decode", "paged_decode_multi"):
        check(dl[name] > 0, f"{name} never launched in the decode replica")
    check(el["flash_fwd"] > 0, "flash_fwd never launched in the encode "
          "replica")
    check(out["flash_dispatch_encode"]["flash"] >= 1,
          f"encode replica took no flash path: "
          f"{out['flash_dispatch_encode']}")
    d = out["decode"]
    check(d["sequences_ok"] == 9 and d["sequences_err"] == 0,
          f"decode sequences: {d}")
    for i, g in enumerate(got_dis):
        check(g[2] == g[3]["generated"] == streams[i],
              f"disaggregated stream {i} {g[3]['generated']} != direct "
              f"{streams[i]}")
    dd = out["disagg"]
    check(dd["kv_spills"] > 0 and dd["kv_restores"] > 0,
          f"the 16-page decode replica never spilled and restored: {dd}")
    check(dd["kv_migrations"] >= 8 and dd["kv_migration_fallbacks"] == 0,
          f"prefilled sequences did not all migrate: {dd}")
    ho = dd["handoffs"]
    check(ho["sent"] >= 8 and ho["adopted"] == ho["sent"]
          and ho["exported"] == 0,
          f"hand-offs did not all stream replica to replica: {ho}")
    check(dd["sequences_ok"] == 8 and dd["sequences_err"] == 0,
          f"disaggregated sequences: {dd}")
    dis_l = {k: sum(r.get(k, 0) for r in dd["launches"]) for k in KERNELS}
    for name in ("flash_fwd", "paged_decode"):
        check(dis_l[name] > 0,
              f"{name} never launched in the disaggregated replicas")
    check(d["decode_steps"] < 9 * (new_tokens + 1),
          f"{d['decode_steps']} scheduler steps: no continuous batching")
    check(out["breaker"] == CLOSED, f"breaker {out['breaker']}")
    check(stats_code == 200 and "decode" in body["deployments"],
          f"/-/stats answered {stats_code}: {body}")
    missing = [g for g in SERVE_GAUGES if g not in text]
    check(not missing, f"decode gauges missing: {missing}")
    emit({"phase": "serve", "streams_equal_direct": True,
          "hit_equals_cold": True, "encode_bit_exact": True,
          "disagg_streamed": True})
    return {k: dl.get(k, 0) + el.get(k, 0) + dis_l[k] + xfer.get(k, 0)
            for k in KERNELS}


def transfer_leg(dev, seed, new_tokens, prompts, hit_prompt, cold_hit):
    """Two BERT-base decode backends on the card, as two replicas would
    hold them: a sequence streamed from one to the other (``send_seq``)
    reaches the peer's receiver as bf16 tensors (never uint16, ROADMAP
    C5) and lands in its pool byte for byte (``adopt_seq``); then the
    prefix the first indexed moves over (``send_prefix``,
    ``adopt_prefix``), and the peer's stream of the prefix-hit prompt
    equals the cold stream token for token, its logits rows within
    ROW_TOL of the cold backend's. Returns the launch counts of the
    peer's hit decode."""
    import torch
    from tosem_tpu_torch.ops import registry
    kw = decode_kwargs(dev, seed, new_tokens)
    Rec = recording_decode()
    warm, peer = Rec(**kw), Rec(**kw)
    out = {"phase": "serve", "transfer": {}}
    try:
        addr = peer.transport_address()
        # a sequence mid-decode, streamed
        warm.admit("s", {"ids": prompts[1]})
        warm.step_batch(["s"], [0])
        sent = warm.export_seq("s")["kv"]
        n = warm.send_seq("s", addr)
        rx = peer._receiver.pop("seq:s", timeout=30.0)
        wire = str(rx.arrays()["k0"].dtype)
        peer._receiver.put_back("seq:s", rx)
        peer.adopt_seq("s")
        landed = peer.export_seq("s")["kv"]
        same = all(landed[k].tobytes() == sent[k].tobytes()
                   for k in ("k", "v"))
        out["transfer"]["seq"] = {"bytes": n, "wire_dtype": wire,
                                  "pages_equal": same}
        check(wire == "torch.bfloat16", f"bf16 pages went as {wire}")
        check(same, "streamed pages differ from the exported ones")
        warm.release("s")
        peer.release("s")
        # a prefix, moved over
        warm.call({"ids": prompts[0]})
        depth, n_tok, h = max(warm.prefix_digest(), key=lambda r: r[0])
        warm.send_prefix(depth, h, addr)
        added = peer.adopt_prefix(h)
        torch.cuda.synchronize()
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        got = peer.call({"ids": hit_prompt})["generated"]
        torch.cuda.synchronize()
        launches = dict(registry.LAUNCH_COUNTS)
        st = peer.cache_stats()
        out["transfer"]["prefix"] = {
            "depth": depth, "tokens": n_tok, "entries_added": added,
            "prefix_remote_imports": st["prefix_remote_imports"],
            "peer_prefix_hits": st["prefix_hits"],
            "hit_decode_ms": (time.perf_counter() - t0) * 1e3,
            "launches": launches}
        emit(out)
        check(st["prefix_remote_imports"] == 1 and st["prefix_hits"] >= 1,
              f"the peer took no transferred prefix: {st}")
        check(got == cold_hit, f"peer's hit stream {got} != cold stream "
              f"{cold_hit}")
        cold = Rec(prefix_cache=False, **kw)
        check(cold.call({"ids": hit_prompt})["generated"] == cold_hit,
              "cold stream differs from the direct one")
        ids_all = hit_prompt + cold_hit
        cold_cid = next(iter(cold.fed))
        peer_cid = next(c for c in peer.fed if str(c).startswith("__call__"))
        hold_rows("prefix_transfer", rows_on(cold, cold_cid, ids_all, tag=0),
                  {k: r for k, r in rows_on(peer, peer_cid, ids_all,
                                            tag=0).items()
                   if k[1] >= len(hit_prompt) - 1}, phase="serve")
        for name in ("paged_decode", "paged_decode_multi"):
            check(launches[name] > 0, f"{name} never launched in the "
                  "peer's hit decode")
        del cold
    finally:
        peer.shutdown()
    del warm, peer
    torch.cuda.empty_cache()
    return launches


def cluster_replica(backend, **kw):
    """A backend as the cluster phase deploys it on node agents: by name,
    ``"chip_smoke:cluster_replica"``, since a replica worker imports its
    backend (this module's top level loads the standard library only).
    ``backend="decode"`` is the serve phase's ``ServedDecode``; any other
    name is a class of ``tosem_tpu_torch.serve.backends`` (the sharded
    replicas) with the same two hooks: the warm-up sets the launch counts
    to 0 as it ends, and ``stats()`` reads them inside the replica."""
    if backend == "decode":
        return replica_classes()[0](**kw)
    from tosem_tpu_torch.serve import backends

    class Counted(getattr(backends, backend)):
        def warmup(self, shapes):
            import torch
            out = super().warmup(shapes)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            reset_counts()
            return out

        def stats(self):
            return replica_stats({})
    return Counted(**kw)


# the sharded replicas' shapes: the parallel phase's (BERT-base attention,
# and paged decode at page 128 with a 4-slot table)
CLUSTER_ATTN_DIMS = dict(batch=8, heads=12, seq=512, dim=64)
CLUSTER_PAGED_DIMS = dict(batch=8, heads=12, head_dim=64, page_size=128,
                          pages=64, table_w=4)
CLUSTER_ROUNDS = 3          # sequential passes over the prompts
CLUSTER_CLIENTS = 8         # the fail-over leg's closed loop
CLUSTER_WINDOW_S = 6.0      # its window before the kill and after re-placing


def percentiles(ms):
    import numpy as np
    return {"p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99)), "n": len(ms)}


def fleet(handle, reqs, key_of, stop, n_clients, records, errors):
    """``n_clients`` threads, each calling ``handle`` with its next
    prompt until ``stop`` is set; each answer lands in ``records`` as
    (end time, seconds, prompt index, generated tokens), each failure in
    ``errors``. Returns the threads, started."""
    import threading
    lock = threading.Lock()

    def client(i):
        k = 0
        while not stop.is_set():
            j = (i + k) % len(reqs)
            t = time.perf_counter()
            try:
                out = handle.call({"ids": reqs[j]}, timeout=120.0,
                                  key=key_of(j))
            except BaseException as e:
                with lock:
                    errors.append(f"client {i} prompt {j}: "
                                  f"{type(e).__name__}: {e}")
                return
            end = time.perf_counter()
            with lock:
                records.append((end, end - t, j, out["generated"]))
            k += 1

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n_clients)]
    for th in threads:
        th.start()
    return threads


def phase_cluster(dev, seed, new_tokens, direct=None):
    """BERT-base served over the cluster plane: node agents spawn the
    replica processes (``RemoteNode.spawn_local``), a ``NodePool`` with a
    journal and a failure detector watches them, and ``ClusterServe``
    routes through two router processes. Two decode replicas spread over
    two of three agents (the third is the spare capacity that
    re-placements land on): keyed requests answer bit for bit the same
    backend's in-process ``call``; a closed loop survives the kill of
    one replica's node with no error reaching a client, while the
    detector declares it dead and the replica is re-placed under its
    id; a sequence stepped on one replica finishes on another after
    ``drain_node`` migrates it; then the sharded replicas (B4 and B1
    over ``sharding=(1, 2)``) hold their gang's slots and equal their
    unsharded kernels bit for bit. Returns the kernels' launch counts
    read inside the replicas."""
    import tempfile
    import threading
    import numpy as np
    import torch
    from tosem_tpu_torch.cluster.node import RemoteNode
    from tosem_tpu_torch.cluster.rpc import RpcClient
    from tosem_tpu_torch.cluster.supervisor import HeadJournal, NodePool
    from tosem_tpu_torch.models.bert import BertConfig
    from tosem_tpu_torch.serve.backends import (BertDecodeBackend,
                                                ShardedAttentionBackend,
                                                ShardedPagedDecodeBackend)
    from tosem_tpu_torch.serve.cluster_serve import ClusterServe
    t_phase = time.perf_counter()
    vocab = BertConfig.base().vocab_size
    prompts, hit_prompt = decode_prompts(seed, vocab)
    reqs = prompts + [hit_prompt]
    # one session a prompt; the prefix-hit prompt shares its donor's, so
    # affinity sends it where the donor's pages are cached
    key_of = lambda j: f"s{0 if j == len(prompts) else j}"   # noqa: E731
    kw = decode_kwargs(dev, seed, new_tokens)
    out = {"phase": "cluster", "gpu": gpu_line()}

    # the same backend in this process, the same prompts in the same
    # order: round 1 meets a cold prefix cache (but for the hit prompt),
    # later rounds find each prompt's own pages
    torch.cuda.empty_cache()
    be = BertDecodeBackend(**kw)
    be.call({"ids": prompts[1][:50], "max_new_tokens": 2})
    local, local_ms = [], []
    for _ in range(CLUSTER_ROUNDS):
        row = []
        for p in reqs:
            t = time.perf_counter()
            row.append(be.call({"ids": p})["generated"])
            local_ms.append((time.perf_counter() - t) * 1e3)
        local.append(row)
    del be
    torch.cuda.empty_cache()
    # what an answer may be: a prompt's stream on a cold cache, or on its
    # own cached pages (a re-placed replica starts cold)
    allowed = [{tuple(local[0][j]), tuple(local[1][j])}
               for j in range(len(reqs))]

    tmp = tempfile.TemporaryDirectory(prefix="chip_cluster_")
    journal = os.path.join(tmp.name, "head.jsonl")
    pool = NodePool(journal_path=journal, heartbeat_interval_s=0.5,
                    miss_threshold=2, probe_timeout=2.0,
                    start_detector=True)
    cs = None
    counts = {}             # replica address -> its last launch counts
    pids = set()

    def read(rep):
        with RpcClient(rep.address, call_timeout=60.0) as cli:
            st = cli.call("stats")
        counts[rep.address] = st["launch_counts"]
        pids.add(st["pid"])
        return st

    try:
        t = time.perf_counter()
        for i in range(3):
            pool.add_node(RemoteNode.spawn_local(num_workers=2),
                          name=f"n{i}")
        cs = ClusterServe(pool, num_routers=2, router_procs=True,
                          replica_startup_timeout=300.0)
        out["agents_routers_s"] = time.perf_counter() - t
        t = time.perf_counter()
        dep = cs.deploy("decode", "chip_smoke:cluster_replica",
                        num_replicas=2, strategy="spread",
                        init_kwargs=dict(kw, backend="decode"),
                        warmup_shapes=SERVE_BUCKETS)
        out["deploy_s"] = time.perf_counter() - t
        placed = {r.replica_id: r.node for r in dep.replicas}
        check(sorted(placed.values()) == ["n0", "n1"],
              f"spread placed {placed}")
        h = cs.get_handle("decode")

        # 1. route: the prompts in turn, each under its session key
        routed, routed_ms = [], []
        for _ in range(CLUSTER_ROUNDS):
            row = []
            for j, p in enumerate(reqs):
                t = time.perf_counter()
                row.append(h.call({"ids": p}, timeout=120.0,
                                  key=key_of(j))["generated"])
                routed_ms.append((time.perf_counter() - t) * 1e3)
            routed.append(row)
        route_stats = [read(r) for r in dep.replicas]
        out["route"] = {
            "routed_ms": percentiles(routed_ms),
            "in_process_ms": percentiles(local_ms),
            "rounds": CLUSTER_ROUNDS, "requests": len(reqs),
            "served": {r.replica_id: st["served"] for r, st in
                       zip(dep.replicas, route_stats)},
            "prefix_hits": sum(st["prefix_hits"] for st in route_stats),
            "cold_equals_cached": [local[0][j] == local[1][j]
                                   for j in range(len(reqs))]}
        if direct is not None:
            out["route"]["equal_decode_phase"] = (
                local[0][:len(prompts)] == direct["streams"]
                and local[0][-1] == direct["hit_stream"])
        emit({"phase": "cluster", "route": out["route"]})
        for r in range(CLUSTER_ROUNDS):
            for j in range(len(reqs)):
                check(routed[r][j] == local[r][j],
                      f"round {r} prompt {j}: routed {routed[r][j]} != "
                      f"in-process {local[r][j]}")

        # 2. fail over: kill one replica's node under a closed loop
        victim = dep.replicas[0]
        records, errors = [], []
        stop = threading.Event()
        t0 = time.perf_counter()
        threads = fleet(h, reqs, key_of, stop, CLUSTER_CLIENTS, records,
                        errors)
        time.sleep(CLUSTER_WINDOW_S)
        read(victim)
        t_kill = time.perf_counter()
        pool.live_nodes()[victim.node].kill()
        t_dead = t_back = None
        deadline = t_kill + 300.0
        while time.perf_counter() < deadline and not errors:
            now = time.perf_counter()
            if t_dead is None and pool.detector.is_dead(victim.node):
                t_dead = now
            back = [r for r in dep.replicas
                    if r.replica_id == victim.replica_id]
            if back and back[0].node != victim.node:
                t_back = now
                break
            time.sleep(0.05)
        if t_back is not None:
            time.sleep(CLUSTER_WINDOW_S)
        stop.set()
        for th in threads:
            th.join(timeout=180.0)
        t_end = time.perf_counter()
        check(not any(th.is_alive() for th in threads),
              "a client of the closed loop never returned")

        def rate(a, b):
            n = sum(1 for e, *_ in records if a < e <= b)
            return n / (b - a) if b > a else None
        wrong = [(j, s) for _, _, j, s in records
                 if tuple(s) not in allowed[j]]
        out["failover"] = {
            "clients": CLUSTER_CLIENTS, "answered": len(records),
            "errors": errors[:5], "n_errors": len(errors),
            "wrong_streams": len(wrong),
            "victim": {"replica": victim.replica_id, "node": victim.node},
            "kill_to_dead_s": None if t_dead is None else t_dead - t_kill,
            "kill_to_replaced_s": None if t_back is None else t_back - t_kill,
            "replaced_on": {r.replica_id: r.node for r in dep.replicas},
            "requests_per_s_before": rate(t0, t_kill),
            "requests_per_s_kill_to_replaced": (
                None if t_back is None else rate(t_kill, t_back)),
            "requests_per_s_after": (
                None if t_back is None else rate(t_back, t_end)),
            "latency_ms_before": percentiles(
                [d * 1e3 for e, d, *_ in records if e <= t_kill]),
            "latency_ms_after": percentiles(
                [d * 1e3 for e, d, *_ in records if t_back and e > t_back]
                or [float("nan")]),
            "routers": [{k: rs.get(k) for k in (
                "routed", "spilled", "retried", "errors", "prefix_routed",
                "prefix_transfers", "prefix_transfer_fails")}
                for rs in cs.stats()["routers"]]}
        emit({"phase": "cluster", "failover": out["failover"]})
        check(not errors, f"{len(errors)} errors reached the clients: "
              f"{errors[:3]}")
        check(t_back is not None, f"replica {victim.replica_id} was not "
              "re-placed within 300 s of its node's death")
        check(not wrong, f"{len(wrong)} answers differ from the in-process "
              f"streams, first: prompt {wrong[0][0] if wrong else None}")
        events = [(e["event"], e.get("replica_id"), e.get("reason"))
                  for e in HeadJournal.load(journal)]
        check(("replica_removed", victim.replica_id, "node_death") in events,
              "the journal has no replica_removed for the victim")
        check(sum(1 for ev, rid, _ in events if ev == "replica_placed"
                  and rid == victim.replica_id) == 2,
              "the journal does not show the victim placed twice")

        # 3. drain with live migration
        src = next(r for r in dep.replicas if r.node == "n1")
        j = 1
        with RpcClient(src.address, call_timeout=120.0) as cli:
            o = cli.call("backend_call", "admit", "drain", {"ids": reqs[j]})
            for step in range(3):
                o = cli.call("backend_call", "step_batch", ["drain"],
                             [step])[0]
        read(src)
        t = time.perf_counter()
        drained = cs.drain_node("n1")
        out["drain"] = {**drained, "seconds": time.perf_counter() - t}
        dst = None
        for r in dep.replicas:
            with RpcClient(r.address, call_timeout=60.0) as cli:
                if "drain" in cli.call("backend_call", "list_seqs"):
                    dst = r
        check(dst is not None and dst.node != "n1",
              f"the drained sequence is on no survivor: {drained}")
        with RpcClient(dst.address, call_timeout=120.0) as cli:
            step = 3
            while not o.get("done"):
                o = cli.call("backend_call", "step_batch", ["drain"],
                             [step])[0]
                step += 1
            res = cli.call("backend_call", "result", "drain")
        out["drain"]["finished_on"] = dst.node
        for r in dep.replicas:
            read(r)
        emit({"phase": "cluster", "drain": out["drain"]})
        check(drained["sequences_migrated"] == 1 and
              drained["replicas_moved"] == 1, f"drain: {drained}")
        check(tuple(res["generated"]) in allowed[j],
              f"the drained sequence gave {res['generated']}, not the "
              f"stream of an undisturbed call {local[0][j]}")
        check(all(r.node != "n1" for r in dep.replicas),
              f"a replica stayed on the drained node: "
              f"{[r.info() for r in dep.replicas]}")
        cs.delete("decode")

        # 4. the sharded replicas, one gang of 2 slots each
        out["sharded"] = {}
        for name, cls, dims, requests in (
                ("paged", "ShardedPagedDecodeBackend", CLUSTER_PAGED_DIMS,
                 ({"seed": 1}, {"seed": 2})),
                ("attention", "ShardedAttentionBackend", CLUSTER_ATTN_DIMS,
                 ({"seed": 1}, {"seed": 2}))):
            before = {n: node.stats()["free_slots"]
                      for n, node in pool.live_nodes().items()}
            t = time.perf_counter()
            sdep = cs.deploy(name, "chip_smoke:cluster_replica",
                             num_replicas=1, sharding=(1, 2),
                             init_kwargs=dict(dims, backend=cls, device=dev),
                             warmup_shapes=[1])
            deploy_s = time.perf_counter() - t
            rep = sdep.replicas[0]
            node = pool.live_nodes()[rep.node]
            held = node.stats()["free_slots"]
            sh = cs.get_handle(name)
            ref_cls = {"ShardedPagedDecodeBackend": ShardedPagedDecodeBackend,
                       "ShardedAttentionBackend": ShardedAttentionBackend}[cls]
            equal = []
            for req in requests:
                got = sh.call(dict(req), timeout=120.0)
                want = ref_cls.reference(dict(req), device=dev, **dims)
                equal.append(np.asarray(got["out"]).tobytes()
                             == want.tobytes())
                check(got["mesh"] == [1, 2] and got["devices"] == 2,
                      f"{name}: {got['mesh']} {got['devices']}")
            st = read(rep)
            cs.delete(name)
            freed = node.stats()["free_slots"]
            out["sharded"][name] = {
                "node": rep.node, "free_slots_before": before[rep.node],
                "free_slots_held": held, "free_slots_after": freed,
                "deploy_s": deploy_s, "bytes_equal": equal,
                "launches": {k: n for k, n in st["launch_counts"].items()
                             if n}}
            check(held == before[rep.node] - 2,
                  f"{name}: free_slots {before[rep.node]} -> {held} while "
                  "the gang holds")
            check(all(equal), f"{name}: a sharded answer differs from the "
                  "unsharded kernel")
            check(freed == before[rep.node], f"{name}: free_slots {freed} "
                  f"after delete, {before[rep.node]} before")
        emit({"phase": "cluster", "sharded": out["sharded"]})
    finally:
        if cs is not None:
            cs.close()
        pool.close(close_nodes=True)
        tmp.cleanup()

    # no replica process may outlive the plane
    deadline = time.perf_counter() + 30
    while time.perf_counter() < deadline and any(
            pid_state(p) == "alive" for p in pids):
        time.sleep(0.2)
    out["replica_pids"] = {p: pid_state(p) for p in sorted(pids)}
    total = {k: sum(c.get(k, 0) for c in counts.values()) for k in KERNELS}
    out["launches"] = {k: n for k, n in total.items() if n}
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "cluster", "gpu": out["gpu"],
          "routed_ms": out["route"]["routed_ms"],
          "in_process_ms": out["route"]["in_process_ms"],
          "requests_per_s_before_kill":
              out["failover"]["requests_per_s_before"],
          "requests_per_s_after_replace":
              out["failover"]["requests_per_s_after"],
          "kill_to_replaced_s": out["failover"]["kill_to_replaced_s"],
          "drain_migrated": out["drain"]["sequences_migrated"],
          "launches": out["launches"], "replica_pids": out["replica_pids"],
          "seconds": out["seconds"]})
    for p in pids:
        check(pid_state(p) != "alive", f"replica {p} outlived the plane")
    for name in ("flash_fwd", "paged_decode", "paged_decode_multi"):
        check(total[name] > 0, f"{name} never launched in the cluster's "
              "replicas")
    return total


def dense_fold_fn(mask):
    """An attn_fn that runs the dense path with a mask program folded
    into the key-padding mask: the reference the sparse encode is held
    against."""
    import torch
    from tosem_tpu_torch.nn.attention import dot_product_attention

    def core(q, k, v, attn_mask):
        T = q.shape[1]
        dm = torch.as_tensor(mask.dense(T, T), device=q.device)[None, None]
        return dot_product_attention(q, k, v, attn_mask.bool() & dm)
    return core


def phase_encode_sparse(dev, seed):
    """Long-document BERT-base encode: ``BertEncodeBackend(preset="base",
    max_batch=8)`` with ``local_window=128`` (routes to local:128:127)
    and with ``doc_len=128`` (doc:128), 8 requests of 300-500 ids padded
    to 512. Each batch must run B1 in schedule mode (12 launches, no
    dense B1) and tally ``cuda:<signature>``; real-token encodings must
    match the same weights with the mask folded densely on the card
    within 2e-2 of the largest value, where a wrong mask (doc:96) must
    fail; one fp32 request must match the CPU within 1e-3. Padded query
    rows are left out of every comparison. The local-window batch is
    also profiled, for B1's device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tosem_tpu_torch.models.bert import Bert, BertConfig, pad_ids_batch
    from tosem_tpu_torch.nn.attention import (FLASH_DISPATCH_COUNTS,
                                              flash_attn_fn)
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.ops.mask_programs import mask_from_spec
    from tosem_tpu_torch.serve.backends import BertEncodeBackend
    rng = np.random.default_rng(seed + 4)
    T, limit = 512, 2e-2
    lens = [int(n) for n in rng.integers(300, 501, size=8)]
    reqs = [{"ids": [int(t) for t in rng.integers(0, 30522, size=n)]}
            for n in lens]
    counts, out = {}, {"lens": lens}
    for kw, spec in (({"local_window": 128}, "local:128:127"),
                     ({"doc_len": 128}, "doc:128")):
        be = BertEncodeBackend(preset="base", max_batch=8, device=dev,
                               seed=seed, pooled=False, **kw)
        mask = mask_from_spec(spec, T)
        be.call_batch(reqs)          # first call: set-up out of the timing
        torch.cuda.synchronize()
        registry.reset_launch_counts()
        tally = dict(FLASH_DISPATCH_COUNTS)
        t0 = time.perf_counter()
        got = be.call_batch(reqs)
        ms = (time.perf_counter() - t0) * 1e3
        c = dict(registry.LAUNCH_COUNTS)
        key = f"cuda:{mask.signature()}"
        served = FLASH_DISPATCH_COUNTS[key] - tally.get(key, 0)
        check(c["flash_fwd_sched"] == 12 and c["flash_fwd"] == 0,
              f"encode {spec}: launches {c}")
        check(served == 12, f"encode {spec}: tally {key} rose by {served}")
        ids, am, _ = pad_ids_batch([r["ids"] for r in reqs], T,
                                   pad_batch_to=8)
        ids, am = (torch.as_tensor(x, device=dev) for x in (ids, am))

        def gap(fn):
            want = be.model.encode_fn(attn_fn=fn)(ids, am).float().cpu()
            rows = [(g["encoding"], want[i, :n].numpy())
                    for i, (g, n) in enumerate(zip(got, lens))]
            scale = max(np.abs(w).max() for _, w in rows)
            return float(max(np.abs(g - w).max() for g, w in rows) / scale)
        sound = gap(dense_fold_fn(mask))
        wrong = gap(dense_fold_fn(mask_from_spec("doc:96", T)))
        check(sound <= limit, f"encode {spec}: card vs dense fold {sound}")
        check(wrong > limit, f"encode {spec}: the check missed doc:96 "
                             f"({wrong})")
        rec = {"batch_ms": ms, "launches": c, "tally": {key: served},
               "rel_gap_vs_dense_fold": sound, "wrong_mask_doc96": wrong}
        if spec.startswith("local"):
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            wall = _timed(lambda: be.call_batch(reqs))
            traced = _timed(lambda: be.call_batch(reqs), prof)
            rec["profile"] = _device_breakdown(prof, wall, traced, 1)
        out[spec] = rec
        for name, n in c.items():
            counts[name] = counts.get(name, 0) + n
        del be
        torch.cuda.empty_cache()
    # one fp32 request, card against CPU, on the same weights
    mask = mask_from_spec("local:128:127", T)
    ids, am, _ = pad_ids_batch([reqs[0]["ids"]], T, pad_batch_to=1)
    enc = {}
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    for where in (dev, "cpu"):
        m = Bert(BertConfig(dtype="float32"), device=where, seed=seed)
        x = m.encode_fn(attn_fn=flash_attn_fn(mask=mask))(
            torch.as_tensor(ids, device=where), torch.as_tensor(am,
                                                                device=where))
        enc[where] = x[0, :lens[0]].float().cpu()
        del m
    fp32 = (enc[dev] - enc["cpu"]).abs().max().item()
    check(fp32 <= 1e-3, f"fp32 sparse encode card vs CPU {fp32}")
    out["fp32_card_vs_cpu"] = fp32
    emit({"phase": "encode_sparse", "limit": limit, **out})
    return counts


def phase_cpu(dev, seed, prompts=3):
    """The card against the CPU on the same weights: first-step logits of
    ``prompts`` 24-token prompts, fp32 and bf16. Two yardsticks read in
    the same run: the card's bf16 logits against the CPU's fp32 ones
    (bf16 rounding alone; the bf16 weights are the fp32 ones rounded),
    and a deliberately wrong CPU model, its layer-0 query projection
    scaled by 1.1 (a 10% softmax-temperature error in one layer of
    twelve), against the card on the first prompt."""
    import numpy as np
    import torch
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    ids = [torch.as_tensor(np.random.default_rng(seed + 2 + i).integers(
        0, 30522, size=(1, 24)), dtype=torch.int32) for i in range(prompts)]
    mask = torch.ones_like(ids[0])

    def first_logits(m, x):
        lg, _, _ = m.prefill_fn()(x.to(m.device), mask.to(m.device))
        return lg[0, -1].float().cpu()

    def gap(a, b):
        return (a - b).abs().max().item()

    lg = {}
    for dtype in ("float32", "bfloat16"):
        for where in (dev, "cpu"):
            m = Bert(BertConfig(dtype=dtype), device=where, seed=seed)
            lg[dtype, where] = [first_logits(m, x) for x in ids]
        with torch.no_grad():
            m.layers[0].attn.q.w.mul_(1.1)
        lg[dtype, "wrong"] = first_logits(m, ids[0])
        del m
    dts = ("float32", "bfloat16")
    sound = {dt: [gap(c, h) for c, h in zip(lg[dt, dev], lg[dt, "cpu"])]
             for dt in dts}
    scale = {dt: max(h.abs().max().item() for h in lg[dt, "cpu"])
             for dt in dts}
    wrong = {dt: gap(lg[dt, dev][0], lg[dt, "wrong"]) for dt in dts}
    rounding = [gap(c, h) for c, h in zip(lg["bfloat16", dev],
                                          lg["float32", "cpu"])]
    same = {dt: [int(c.argmax()) == int(h.argmax())
                 for c, h in zip(lg[dt, dev], lg[dt, "cpu"])] for dt in dts}
    for dt in dts:
        check(all(torch.isfinite(c).all().item() for c in lg[dt, dev]),
              f"non-finite {dt} logits on the card")
    # fp32 is held to 1e-3 absolute, and the wrong model must break it;
    # bf16 rounds every layer's output (12 layers, other summation orders
    # on each device), so it is held to 2e-2 of the largest logit
    check(max(sound["float32"]) <= 1e-3,
          f"fp32 cuda vs cpu first-step logits differ: {sound}")
    check(wrong["float32"] > 1e-3,
          f"the fp32 check cannot see the wrong model: {wrong}")
    check(max(sound["bfloat16"]) <= 2e-2 * max(1.0, scale["bfloat16"]),
          f"bf16 cuda vs cpu first-step logits differ: {sound}, "
          f"largest logit {scale}")
    emit({"phase": "cpu", "prompt_len": 24, "prompts": prompts,
          "max_abs_diff": sound, "max_abs_logit": scale,
          "bf16_limit": 2e-2 * max(1.0, scale["bfloat16"]),
          "card_bf16_vs_cpu_fp32": rounding,
          "wrong_model_vs_card": wrong, "same_argmax": same})


def _device_breakdown(prof, wall_ms, traced_ms, n, top=8):
    """Device time per iteration from a profiler trace, over the wall
    time of ``n`` iterations run without the profiler (``wall_ms``) and
    under it (``traced_ms``): the device's busy share of the unprofiled
    wall time, the kernels that took most of the device time, and the
    device time of each of the port's own kernels (those of ``csrc/``:
    flash, paged-decode, layernorm and softmax kernels in an anonymous
    namespace) wherever it ranks."""
    import collections

    import torch
    per = collections.Counter()
    for e in prof.events():
        # a user annotation (the optimizer's step range) spans kernels
        # that the trace also lists: count the kernels only
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            per[e.name] += e.time_range.elapsed_us() / 1e3 / n
    busy = sum(per.values())
    return {"wall_ms": wall_ms / n, "traced_wall_ms": traced_ms / n,
            "device_ms": busy, "device_busy_share": busy / (wall_ms / n),
            "top": [[name[:80], ms] for name, ms in per.most_common(top)],
            "port_kernels": {name.split("::")[1].split("(")[0]: ms
                             for name, ms in per.items()
                             if name.startswith(PORT_KERNEL_NAMES)}}


def _timed(fn, prof=None):
    """Host-clock ms of ``fn()`` up to a device sync, optionally traced."""
    import contextlib

    import torch
    with prof if prof is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3


def phase_profile(dev, seed, steps=5):
    """Where the time goes, over decode steps of 8 packed sequences, a
    384-token prefill, windowed, speculative and beam steps, and a padded
    encode batch. Each is run once without the profiler for its wall
    time, then once more under it for its device time: the next
    ``steps`` decode steps (a token longer each), another 384-token
    prompt, the next 3 steps of each mode, the same encode batch."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tosem_tpu_torch.serve.backends import (BertDecodeBackend,
                                                BertEncodeBackend)
    rng = np.random.default_rng(seed)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def rand_ids(n):
        return [int(t) for t in rng.integers(0, 30522, int(n))]

    be = BertDecodeBackend(preset="base", max_batch=8, num_pages=64,
                           max_new_tokens=2 * steps + 4, device=dev,
                           seed=seed)
    for i in range(8):
        be.admit(i, {"ids": rand_ids(rng.integers(100, 401))})
    be.step_batch(list(range(8)), [0] * 8)
    torch.cuda.synchronize()

    def run_steps(first):
        for k in range(first, first + steps):
            be.step_batch(list(range(8)), [k] * 8)
    wall = _timed(lambda: run_steps(1))
    prof = profile(activities=acts)
    traced = _timed(lambda: run_steps(1 + steps), prof)
    decode = _device_breakdown(prof, wall, traced, steps)
    wall = _timed(lambda: be.admit("p0", {"ids": rand_ids(384)}))
    prof = profile(activities=acts)
    traced = _timed(lambda: be.admit("p1", {"ids": rand_ids(384)}), prof)
    prefill = _device_breakdown(prof, wall, traced, 1)
    del be
    # a windowed, a speculative and a beam step: 8 sequences of 100-400
    # tokens (two beam groups of 4), 3 steps for wall time, 3 traced
    modes = {}
    for name, mode, n in (("window_step", {"window": WINDOW}, 1),
                          ("spec_step", {"spec_k": SPEC_K}, 1),
                          ("beam_step", {}, 4)):
        be = BertDecodeBackend(preset="base", max_batch=8, num_pages=64,
                               max_new_tokens=32, device=dev, seed=seed,
                               **mode)
        sids = list(range(8 // n))
        for i in sids:
            req = {"ids": rand_ids(rng.integers(100, 401))}
            be.admit(i, {**req, "n": n, "beam": True} if n > 1 else req)
        be.step_batch(sids, [0] * len(sids))
        torch.cuda.synchronize()

        def run_mode(first, be=be, sids=sids):
            for k in range(first, first + 3):
                outs = be.step_batch(sids, [k] * len(sids))
                check(not any(o["done"] for o in outs),
                      f"{name}: a sequence finished inside the window")
        wall = _timed(lambda: run_mode(1))
        prof = profile(activities=acts)
        traced = _timed(lambda: run_mode(4), prof)
        modes[name] = _device_breakdown(prof, wall, traced, 3)
        del be
    enc = BertEncodeBackend(preset="base", max_batch=8, device=dev, seed=seed)
    reqs = [{"ids": rand_ids(n)} for n in rng.integers(30, 501, size=8)]
    enc.call_batch(reqs)
    torch.cuda.synchronize()
    wall = _timed(lambda: enc.call_batch(reqs))
    prof = profile(activities=acts)
    traced = _timed(lambda: enc.call_batch(reqs), prof)
    encode = _device_breakdown(prof, wall, traced, 1)
    emit({"phase": "profile", "decode_step": decode,
          "prefill_384": prefill, "encode_batch": encode, **modes})


class _Preempt:
    """A chaos controller that preempts ``fit`` after step ``at``."""

    def __init__(self, at):
        self.at = at

    def on(self, site, **ctx):
        if site == "train.step" and ctx.get("step") == self.at:
            return {"action": "preempt"}
        return None


def _mlm_batch(ids, masked, mask=None):
    batch = {"ids": ids, "labels": ids, "masked": masked}
    if mask is not None:
        batch["mask"] = mask
    return batch


def train_steps(model, init, batch, attn_fn, seed, warmup, steps):
    """The ``bert_train`` leg on the port: from the initial weights, a
    fresh adamw(1e-4), ``warmup`` steps, then ``steps`` timed steps on
    the same batch. Returns (state, step_fn, losses, ms per step,
    launches of the timed steps)."""
    import functools

    import torch
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.train import (adamw, create_train_state,
                                       make_train_step, mlm_loss)
    from tosem_tpu_torch.train.trainer import step_generator
    dev = batch["ids"].device
    model.load_state_dict(init)
    st = create_train_state(model, adamw(1e-4))
    step = make_train_step(model, st.optimizer,
                           functools.partial(mlm_loss, attn_fn=attn_fn))
    for i in range(warmup):
        st, _ = step(st, batch, step_generator(seed, i, dev))
    torch.cuda.synchronize()
    registry.reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for i in range(warmup, warmup + steps):
        st, met = step(st, batch, step_generator(seed, i, dev))
        losses.append(met["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    return st, step, [float(x) for x in losses], ms, \
        dict(registry.LAUNCH_COUNTS)


GRAD_NAMES = ["tok.table"] + [f"layers.{i}.attn.{p}.w" for i in (0, 11)
                              for p in "qkvo"]


def train_grads(where, attn_fn, batch, seed, wrong=False):
    """One step's fp32 gradients (no TF32, dropout 0) of the tensors in
    GRAD_NAMES, on the CPU. ``wrong`` scales layer 0's query projection
    by 1.1 first: the yardstick the check must catch."""
    import dataclasses

    import torch
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.ops.common import precision
    from tosem_tpu_torch.train import mlm_loss
    cfg = dataclasses.replace(BertConfig.base(), dtype="float32",
                              precision="float32", dropout=0.0)
    m = Bert(cfg, device=where, seed=seed)
    if wrong:
        with torch.no_grad():
            m.layers[0].attn.q.w.mul_(1.1)
    with precision("float32"):
        loss, _ = mlm_loss(m, {k: v.to(where) for k, v in batch.items()},
                           None, attn_fn=attn_fn)
        loss.backward()
    params = dict(m.named_parameters())
    return {n: params[n].grad.detach().float().cpu() for n in GRAD_NAMES}


def _rel_gaps(got, want):
    return {n: ((got[n] - want[n]).abs().max()
                / want[n].abs().max().clamp_min(1e-30)).item()
            for n in GRAD_NAMES}


TRAIN_STEPS = 10       # timed bert_train steps an arm
TRAIN_WARMUP = 2       # the CLI leg's warm-up steps
TRAIN_TRACED = 3       # flash steps its --profile traces (one untraced first)


def summary_calls(summary, name):
    """Calls of the port's kernel ``name`` (``flash_fwd``, ...) in a
    kernel-summary CSV's rows, whatever its template arguments."""
    return sum(int(r["calls"]) for r in summary
               if r["name"].startswith(f"{PORT_PREFIX}{name}_"))


def phase_train(dev, seed, steps=TRAIN_STEPS):
    """The JAX package's ``bert_train`` leg (``tosem_tpu/cli.py``) on the
    port, through its experiment runner: ``cli.main(["--config=
    bert_train", "--steps=10", "--profile"])``. BERT-base, bf16, dropout
    0.1, weights from seed 0, adamw(1e-4), an 8 x 512 batch of random
    ids from numpy seed 1 with labels = ids and 15% of positions masked;
    flash attention (B1, B2, B3) against dense attention on the same
    weights and batch; the train FLOPs are the reference's count,
    6*N*B*T + 3*12*L*B*T^2*dim. Then one step on a padded batch (the
    kernels' segment mode)."""
    import csv
    import functools
    import tempfile

    import numpy as np
    import torch
    from tosem_tpu_torch import cli
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.train import (adamw, create_train_state,
                                       make_train_step, mlm_loss)
    from tosem_tpu_torch.train.trainer import step_generator
    from tosem_tpu_torch.utils.results import read_results
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="torch_bert_train_") as d:
        path = os.path.join(d, "bert_train.csv")
        check(cli.main(["--config=bert_train", f"--steps={steps}",
                        "--profile", f"--results_csv={path}"]) == 0,
              "the bert_train config failed")
        # the runner set the counts to 0 as the config began
        counts = {k: registry.LAUNCH_COUNTS[k] for k in KERNELS}
        rows = {(r["bench_id"], r["metric"]): r for r in read_results(path)}
        with open(os.path.join(d, "profile", "bert_train_gpu",
                               "kernel_summary.csv")) as f:
            summary = list(csv.DictReader(f))
    mem = torch.cuda.max_memory_allocated() / 2**30
    flash = rows[("bert_base_b8_t512_flash", "step_time_ms")]
    dense = rows[("bert_base_b8_t512_xla", "step_time_ms")]
    losses = flash["extra"]["losses"]
    dense_losses = dense["extra"]["losses"]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"train losses {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(all(np.isfinite(dense_losses)), f"dense loss {dense_losses}")
    for key in (("bert_base_b8_t512_flash", "train_gflops"),
                ("bert_base_b8_t512_xla", "train_gflops"),
                ("bert_b8_t512_flash_vs_xla", "speedup")):
        check(key in rows, f"bert_train row {key} missing")
    want = 12 * (TRAIN_WARMUP + steps) + 12 * (1 + TRAIN_TRACED)
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        check(counts[name] == want,
              f"{name}: {counts[name]} launches in the bert_train leg, "
              f"not {want}")
        calls = summary_calls(summary, name)
        check(calls == 12 * TRAIN_TRACED,
              f"kernel summary: {name} {calls} calls in {TRAIN_TRACED} "
              f"traced steps, not 12 a step")
    device_us = sum(float(r["total_us"]) for r in summary)
    step_ms = flash["value"]
    device_ms = device_us / TRAIN_TRACED / 1e3

    # one step on a padded batch: key padding rides B1-B3 as segment ids
    cfg = BertConfig.base()
    B, T = 8, 512
    rng = np.random.default_rng(seed + 1)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                          device=dev)
    masked = torch.as_tensor(rng.random((B, T)) < 0.15, device=dev)
    lens = [int(n) for n in rng.integers(30, 501, size=B)]
    pmask = torch.zeros(B, T, dtype=torch.int32)
    for b, n in enumerate(lens):
        pmask[b, :n] = 1
    pmask = pmask.to(dev)
    pbatch = _mlm_batch(ids * pmask, masked & pmask.bool(), pmask)
    model = Bert(cfg, device=dev, seed=seed)
    st = create_train_state(model, adamw(1e-4))
    step = make_train_step(model, st.optimizer, functools.partial(
        mlm_loss, attn_fn=flash_attn_fn()))
    registry.reset_launch_counts()
    st, met = step(st, pbatch, step_generator(seed, 0, dev))
    padded_loss = float(met["loss"])
    pcounts = dict(registry.LAUNCH_COUNTS)
    check(np.isfinite(padded_loss), f"padded batch loss {padded_loss}")
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        check(pcounts[name] == 12, f"{name}: {pcounts[name]} launches on "
                                   "the padded batch")
    del st, step, model
    torch.cuda.empty_cache()
    flops = rows[("bert_base_b8_t512_flash", "train_gflops")][
        "extra"]["flops_per_step"]
    emit({"phase": "train", "config": "BERT-base bf16 dropout 0.1",
          "via": "tosem_tpu_torch.cli --config=bert_train --profile",
          "batch": [B, T], "params": flash["extra"]["params"],
          "flops_per_step": flops, "warmup": TRAIN_WARMUP, "steps": steps,
          "losses": losses, "step_ms": step_ms,
          "tokens_per_s": B * T / step_ms * 1e3,
          "train_gflops": rows[("bert_base_b8_t512_flash",
                                "train_gflops")]["value"],
          "share_of_989_tflops": flops / (step_ms * 1e-3) / 989e12,
          "dense_losses": dense_losses, "dense_step_ms": dense["value"],
          "dense_tokens_per_s": B * T / dense["value"] * 1e3,
          "flash_vs_dense_speedup": rows[("bert_b8_t512_flash_vs_xla",
                                          "speedup")]["value"],
          "padded_lens": lens, "padded_loss": padded_loss,
          "launches_cli_leg": counts, "launches_padded_step": pcounts,
          "max_memory_gib": mem,
          "kernel_summary": {
              "traced_steps": TRAIN_TRACED,
              "device_ms_per_step": device_ms,
              "device_busy_share": device_ms / step_ms,
              "top": [[r["name"][:80], int(r["calls"]) // TRAIN_TRACED,
                       float(r["total_us"]) / TRAIN_TRACED / 1e3,
                       float(r["pct"])] for r in summary[:12]],
              "port_kernels": {
                  name: {"calls_per_step": summary_calls(summary, name)
                         / TRAIN_TRACED,
                         "ms_per_step": sum(
                             float(r["total_us"]) for r in summary
                             if r["name"].startswith(
                                 f"{PORT_PREFIX}{name}_"))
                         / TRAIN_TRACED / 1e3}
                  for name in ("flash_fwd", "flash_bwd_dkv",
                               "flash_bwd_dq")}}})
    return {k: counts[k] + pcounts[k] for k in KERNELS}


def phase_train_grads(dev, seed):
    """fp32 gradients of one step at 2 x 128 (dropout 0, no TF32): the
    card's flash path against its dense path and against the CPU's plain
    path, each as the largest gap over the largest gradient, per tensor;
    a CPU model made wrong on purpose must fail the same check."""
    import numpy as np
    import torch
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    rng = np.random.default_rng(seed + 3)
    ids = torch.as_tensor(rng.integers(0, 30522, (2, 128)))
    batch = _mlm_batch(ids, torch.as_tensor(rng.random((2, 128)) < 0.15))
    card = train_grads(dev, flash_attn_fn(), batch, seed)
    dense = train_grads(dev, None, batch, seed)
    cpu = train_grads("cpu", flash_attn_fn(), batch, seed)
    wrong = train_grads("cpu", flash_attn_fn(), batch, seed, wrong=True)
    gaps = {"flash_vs_dense_card": _rel_gaps(card, dense),
            "card_vs_cpu": _rel_gaps(card, cpu),
            "card_vs_wrong_cpu": _rel_gaps(card, wrong)}
    limit = 1e-3
    for what in ("flash_vs_dense_card", "card_vs_cpu"):
        check(max(gaps[what].values()) <= limit,
              f"fp32 gradients {what} beyond {limit}: {gaps[what]}")
    check(max(gaps["card_vs_wrong_cpu"].values()) > limit,
          f"the gradient check cannot see the wrong model: {gaps}")
    emit({"phase": "train_grads", "batch": [2, 128], "limit": limit,
          "relative_gaps": gaps})


def phase_train_remat(dev, seed):
    """One BERT-base train step (bf16, dropout 0.1 from a generator on the
    card, flash attention, 8 x 512) with ``remat`` full and dots against
    none, from the same weights and generator seed: loss and every
    gradient bit for bit. ``torch.utils.checkpoint`` replays only the
    default generators, so this fails if a recomputed layer draws new
    dropout masks from the step's generator."""
    import dataclasses
    import functools

    import numpy as np
    import torch
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    from tosem_tpu_torch.train import mlm_loss
    from tosem_tpu_torch.train.trainer import step_generator
    rng = np.random.default_rng(seed + 1)
    ids = torch.as_tensor(rng.integers(0, 30522, (8, 512)), device=dev)
    batch = _mlm_batch(ids, torch.as_tensor(rng.random((8, 512)) < 0.15,
                                            device=dev))
    loss_fn = functools.partial(mlm_loss, attn_fn=flash_attn_fn())
    out = {}
    for remat in ("none", "full", "dots"):
        model = Bert(dataclasses.replace(BertConfig.base(), remat=remat),
                     device=dev, seed=seed)
        torch.cuda.reset_peak_memory_stats()
        loss, _ = loss_fn(model, batch, step_generator(seed, 0, dev))
        loss.backward()
        out[remat] = (loss.detach(), {n: p.grad for n, p in
                                      model.named_parameters()
                                      if p.grad is not None},
                      torch.cuda.max_memory_allocated() / 2**30)
        del model
    base = out["none"]
    for remat in ("full", "dots"):
        loss, grads, _ = out[remat]
        check(torch.equal(loss, base[0]),
              f"remat={remat} loss {loss.item()} != {base[0].item()}")
        check(grads.keys() == base[1].keys() and
              all(torch.equal(grads[n], base[1][n]) for n in base[1]),
              f"remat={remat} gradients differ from remat=none")
    emit({"phase": "train_remat", "loss": base[0].item(), "bit_exact": True,
          "peak_gib": {k: v[2] for k, v in out.items()}})
    del out, base
    torch.cuda.empty_cache()


def phase_train_resume(dev, seed, layers=2, steps=4):
    """``fit`` at BERT-base width with ``layers`` layers (bf16, dropout
    0.1, flash attention, 8 x 512): the loss history of a run preempted
    through the chaos hook after step 3 and resumed from its step-2
    checkpoint equals the uninterrupted run's bit for bit, with
    PyTorch's default (non-deterministic-algorithm) settings."""
    import dataclasses
    import functools
    import tempfile

    import numpy as np
    import torch
    from tosem_tpu_torch.chaos import install, uninstall
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    from tosem_tpu_torch.train import (TrainingPreempted, adamw,
                                       create_train_state, fit,
                                       make_train_step, mlm_loss)
    cfg = dataclasses.replace(BertConfig.base(), layers=layers)

    def batch_fn(step):
        rng = np.random.default_rng([seed, step])
        ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 512)),
                              device=dev)
        return _mlm_batch(ids, torch.as_tensor(rng.random((8, 512)) < 0.15,
                                               device=dev))

    def run(**kw):
        model = Bert(cfg, device=dev, seed=seed)
        st = create_train_state(model, adamw(1e-4))
        step = make_train_step(model, st.optimizer, functools.partial(
            mlm_loss, attn_fn=flash_attn_fn()))
        return fit(st, step, batch_fn, steps, seed=seed, **kw)[1]

    t0 = time.perf_counter()
    want = run()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_ckpt_") as ck:
        install(_Preempt(3))
        try:
            run(ckpt_dir=ck, checkpoint_every=2)
            preempted = False
        except TrainingPreempted:
            preempted = True
        finally:
            uninstall()
        saved = sorted(os.listdir(ck))
        got = run(ckpt_dir=ck, checkpoint_every=2)
    check(preempted, "the chaos hook did not preempt fit")
    check(saved == ["ckpt_00000002"], f"checkpoints at preemption: {saved}")
    check(got == want, f"resumed history {got} != uninterrupted {want}")
    torch.cuda.empty_cache()
    emit({"phase": "train_resume", "layers": layers, "steps": steps,
          "preempted_after": 3, "checkpoints_at_preemption": saved,
          "history": [h["loss"] for h in want], "bit_exact": True,
          "seconds": time.perf_counter() - t0})


# ------------------------------------------------------- data-parallel train

DP_STEPS = 3        # steps of each data-parallel run
DP_GRAIN = 4        # logical shards of the 8 x 512 batch: 2 x 512 each
# the BERT-base job's transport: every gradient leaf is fp32 (440 MB a
# shard-step). 64 MiB buckets (the 93.8 MB token table rides alone), 4
# MiB chunks, and a receive segment of twice the gradient bytes (one
# partial and one final sum of every bucket at once), so nothing spills
# to the heap
DP_CFG = dict(grain=DP_GRAIN, bucket_bytes=64 << 20, chunk_bytes=4 << 20,
              transport_capacity=1 << 30)


def bert_dp_job(dev, seed, batch):
    """BERT-base masked-LM as a one-stage ``DPJob``: fp32 master weights
    from ``seed`` with bf16 compute (``mixed_precision``), dropout 0.1,
    adamw(1e-4), flash attention (B1-B3), ``batch`` every step, grain 4.
    The stage loss binds the stage's parameters to one module through
    ``torch.func.functional_call`` (the tied LM head stays fp32, as in
    ``models/bert.py``). The ranks are threads of one process and that
    call swaps the module's parameters while the forward runs, so the
    forwards take a lock; each backward runs outside it."""
    import dataclasses
    import functools
    import threading

    import torch
    from torch import nn
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    from tosem_tpu_torch.train import adamw, mlm_loss
    from tosem_tpu_torch.train.distributed import DPJob
    model = Bert(dataclasses.replace(BertConfig.base(), dtype="float32"),
                 device=dev, seed=seed)
    init = {n: p.detach() for n, p in model.named_parameters()}
    attn = flash_attn_fn()

    class MLM(nn.Module):
        def __init__(self, bert):
            super().__init__()
            self.bert = bert

        def forward(self, b, generator):
            return mlm_loss(self.bert, b, generator, attn_fn=attn)[0]
    wrapper, lock = MLM(model), threading.Lock()

    def loss(params, b, generator):
        bound = {f"bert.{n}": t for n, t in params["bert"].items()}
        with lock:
            return torch.func.functional_call(wrapper, bound, (b, generator))

    return DPJob(init_params=lambda: {"bert": init},
                 stage_losses=[("bert", loss)],
                 batch_fn=lambda step: batch,
                 optimizer=adamw(1e-4), grain=DP_GRAIN,
                 global_batch=int(batch["ids"].shape[0]), seed=seed,
                 mixed_precision=True)


def dp_breakdown(prof, outs, wall_ms):
    """One profiled data-parallel step: the device's kernel time, its
    device-to-host and host-to-device copy time (the trace's ``Memcpy``
    rows), and each rank's host-clock compute region (forward, backward
    and the gradients' host copies), chain reduce (transport and host
    folds; the buckets' reduces run at once, so the longest one and their
    sum) and apply (the sum's host-to-device copy, the optimizer)."""
    import torch
    dev = {"kernels_ms": 0.0, "dtoh_ms": 0.0, "htod_ms": 0.0,
           "other_ms": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        ms = e.time_range.elapsed_us() / 1e3
        key = ("dtoh_ms" if e.name.startswith("Memcpy DtoH") else
               "htod_ms" if e.name.startswith("Memcpy HtoD") else
               "other_ms" if e.name.startswith(("Memcpy", "Memset")) else
               "kernels_ms")
        dev[key] += ms
    ranks = [{"compute_ms": o["compute_ms"], "apply_ms": o["apply_ms"],
              "reduce_ms_longest_bucket": max(r["ms"] for r in
                                              o["reduce"].values()),
              "reduce_ms_all_buckets": sum(r["ms"] for r in
                                           o["reduce"].values()),
              "reduce_mb_sent": sum(r["bytes"] for r in
                                    o["reduce"].values()) / 2**20,
              "buckets": len(o["reduce"])} for o in outs]
    return {"wall_ms": wall_ms, "device": dev, "ranks": ranks}


def phase_train_dp(dev, seed):
    """Data-parallel BERT-base training through ``DistributedTrainer``
    (threads backend, the chain all-reduce over the tensor transport):
    the ``bert_train`` leg's 8 x 512 batch from ``seed + 1`` as 4 logical
    shards of 2 x 512, 3 steps at world 1, 2 and 4, at world 4 with
    ``overlap=False``, and at world 4 with the last rank lost at step 1
    (chaos ``train.dist_step``/``kill_node``) and a rank grown back after
    it. Every run's loss history and final parameters must equal the
    single-process local fold (``make_dp_train_step``) bit for bit,
    ``torch.equal`` on every tensor, and B1, B2 and B3 must launch 12 a
    shard computed: 12 x 4 x 3 a run, and 3 shards more in the shrink
    run (the survivors of the lost rank compute step 1's shards before
    the chain aborts). Prints the step ms per world beside the plain
    ``make_train_step`` on the same batch (a bf16 model), one profiled
    world-4 step split into device compute, copies and transport, and the
    peak device memory. Returns the launch counts of the checked runs."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tosem_tpu_torch.chaos import ChaosController, Fault, FaultPlan
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.train.distributed import (DataParallelConfig,
                                                   DistributedTrainer,
                                                   make_dp_train_step)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 1)
    ids = torch.as_tensor(rng.integers(0, 30522, (8, 512)), device=dev)
    masked = torch.as_tensor(rng.random((8, 512)) < 0.15, device=dev)
    batch = _mlm_batch(ids, masked)
    job = bert_dp_job(dev, seed, batch)
    flash = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    counts = {k: 0 for k in KERNELS}
    out = {"phase": "train_dp", "gpu": gpu_line(),
           "config": "BERT-base fp32 master, bf16 compute, dropout 0.1, "
                     "adamw(1e-4), flash attention",
           "batch": [8, 512], "grain": DP_GRAIN, "steps": DP_STEPS,
           "transport": DP_CFG, "runs": {}}

    def counted(what, shards):
        c = dict(registry.LAUNCH_COUNTS)
        for k in flash:
            check(c[k] == 12 * shards,
                  f"train_dp {what}: {k} launched {c[k]} times, expected "
                  f"12 x {shards} shards")
        for k in counts:
            counts[k] += c[k]
        registry.reset_launch_counts()
        return {k: c[k] for k in flash}

    # the single-process local fold: the trajectory every run must equal
    state = job.init_state()
    step_fn = make_dp_train_step(job)
    torch.cuda.synchronize()
    registry.reset_launch_counts()
    ref_losses, ref_ms = [], []
    for _ in range(DP_STEPS):
        t0 = time.perf_counter()
        state, m = step_fn(state)
        torch.cuda.synchronize()
        ref_ms.append((time.perf_counter() - t0) * 1e3)
        ref_losses.append(m["loss"])
    out["local_fold"] = {"losses": ref_losses, "step_ms": ref_ms,
                         "launches": counted("local fold",
                                             DP_GRAIN * DP_STEPS)}
    check(all(np.isfinite(ref_losses)), f"local fold losses {ref_losses}")
    ref_params = [p.detach().clone() for p in state.leaves()]
    del state, step_fn

    def held(what, tr, losses):
        params = tr.fetch_state().leaves()
        same = (len(params) == len(ref_params) and
                all(torch.equal(a, b) for a, b in zip(params, ref_params)))
        check(losses == ref_losses,
              f"train_dp {what}: losses {losses} != local fold {ref_losses}")
        check(same, f"train_dp {what}: final parameters differ from the "
                    "local fold")

    def run(what, world, overlap=True, shrink_grow=False, profiled=False):
        cfg = DataParallelConfig(job=f"bert-{what}", overlap=overlap,
                                 **DP_CFG)
        marks = []
        torch.cuda.synchronize()
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        with DistributedTrainer(job=job, cfg=cfg, world=world) as tr:
            def on_step(done, _):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
            if shrink_grow:
                plan = FaultPlan(seed=seed, name="dp-shrink", faults=[
                    Fault(site="train.dist_step", action="kill_node",
                          at=2)])
                with ChaosController(plan):
                    tr.fit(2, on_step=on_step)
                check(tr.world == world - 1 and tr.stats()["shrinks"] == 1,
                      f"train_dp {what}: no shrink: {tr.stats()}")
                tr.add_worker()
                losses = tr.fit(DP_STEPS, on_step=on_step)
                check(tr.world == world and tr.stats()["grows"] == 1,
                      f"train_dp {what}: no grow: {tr.stats()}")
            else:
                losses = tr.fit(DP_STEPS, on_step=on_step)
            shards = DP_GRAIN * DP_STEPS + (DP_GRAIN - 1) * shrink_grow
            rec = {"world": world, "overlap": overlap, "losses": losses,
                   "step_ms": [(b - a) * 1e3 for a, b in
                               zip([t0] + marks[:-1], marks)],
                   "launches": counted(what, shards),
                   "stats": tr.stats()}
            held(what, tr, losses)
            if profiled:
                # one more step, traced: the step's breakdown
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                tr.fit(DP_STEPS + 1)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t1) * 1e3
                # the device's activity only: tracing the host's ops
                # as well stretched this step thirtyfold
                prof = profile(activities=[ProfilerActivity.CUDA])
                with prof:
                    t1 = time.perf_counter()
                    tr.fit(DP_STEPS + 2)
                    torch.cuda.synchronize()
                    traced = (time.perf_counter() - t1) * 1e3
                rec["breakdown"] = dp_breakdown(prof, tr.last_step_outs,
                                                traced)
                rec["breakdown"]["unprofiled_wall_ms"] = wall
                registry.reset_launch_counts()
        out["runs"][what] = rec
        emit({"phase": "train_dp", "run": what, "gpu": out["gpu"], **rec})

    run("world1", 1)
    run("world2", 2)
    run("world4", 4, profiled=True)
    run("world4_serial", 4, overlap=False)
    run("world4_shrink_grow", 4, shrink_grow=True)
    del job
    torch.cuda.empty_cache()
    # the plain train step on the same batch: one bf16 model, no shards
    model = Bert(BertConfig.base(), device=dev, seed=seed)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    _, _, plain_losses, plain_ms, _ = train_steps(
        model, init, batch, flash_attn_fn(), seed, 1, DP_STEPS)
    registry.reset_launch_counts()
    del model, init
    torch.cuda.empty_cache()
    out["plain_make_train_step"] = {"step_ms": plain_ms,
                                    "losses": plain_losses,
                                    "model": "bf16 weights, no shards"}
    out["step_ms_by_world"] = {
        w: float(np.mean(out["runs"][w]["step_ms"][1:]))
        for w in ("world1", "world2", "world4", "world4_serial")}
    out["local_fold_step_ms"] = float(np.mean(ref_ms[1:]))
    out["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds"] = time.perf_counter() - t_phase
    out["bit_exact"] = True
    emit({k: v for k, v in out.items() if k != "runs"})
    return counts


# ---------------------------------------------------------------- parallel

PAR_POSITIONS = 4   # positions of the one-card meshes (dp x tp = 2 x 2)
PAR_FLASH_MESHES = ((2, 2), (1, 4), (2, 3))
PAR_RING_T = 512    # ring/Ulysses sequence, split over sp = 4
PAR_SWEEP_MAX = 1 << 26     # the allreduce rows: 1 KB to 64 MB a position


def phase_parallel(dev, seed):
    """The device mesh (``tosem_tpu_torch.parallel``) on one card, every
    position on it: the six collectives exact on integer-valued fp32 over
    4 positions and their bus-bandwidth rows (``--config=allreduce``);
    sharded flash (B1) equal to the unsharded kernel bit for bit at
    BERT-base's attention ([8, 512, 12, 64] bf16, padding segments) over
    (dp, tp) = (2, 2), (1, 4) and (2, 3), and a 12-head MultiHeadMask
    (schedule mode) at tp = 4; sharded paged decode equal to the
    unsharded B4 (q [8, 12, 64], page 128, lengths 0-512), B5 at k = 4
    and B5 windowed on rolling tables; both sharded replicas equal to
    their ``reference()`` in every request mode; the shard_map
    data-parallel step on the train_dp job (a dp mesh of 4 positions)
    within rtol 2e-5 of the local fold; ring and Ulysses attention at
    BERT-base heads, T = 512 over sp = 4, fp32 outputs and gradients
    against the plain attention. Every sharded path's launches equal
    positions x calls; every join of position threads has a time limit
    (``shard_map``'s ``timeout``). Returns the launch counts of the
    sharded paths."""
    import numpy as np
    import torch
    from tosem_tpu_torch import cli
    from tosem_tpu_torch.nn.attention import dot_product_attention
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.ops.flash_attention import flash_attention
    from tosem_tpu_torch.ops.paged_attention import paged_attention
    from tosem_tpu_torch.parallel import collectives as col
    from tosem_tpu_torch.parallel import (MeshSpec, default_mesh, dp_tp_mesh,
                                          make_mesh, make_ring_attn_fn,
                                          make_ulysses_attn_fn,
                                          sharded_flash_attention,
                                          sharded_paged_attention)
    from tosem_tpu_torch.serve.backends import (ShardedAttentionBackend,
                                                ShardedPagedDecodeBackend)
    from tosem_tpu_torch.train.distributed import make_dp_train_step
    t_phase = time.perf_counter()
    gpu = gpu_line()
    out = {"phase": "parallel", "gpu": gpu, "launches": {}}
    counts = {k: 0 for k in KERNELS}
    gen = torch.Generator().manual_seed(seed + 12)

    def launched(what, want):
        """The launch counts since the last reset must be ``want`` ({kernel:
        positions x calls}), every other kernel 0."""
        c = dict(registry.LAUNCH_COUNTS)
        got = {k: v for k, v in c.items() if v}
        check(got == want, f"parallel {what}: launches {got} != {want}")
        for k in counts:
            counts[k] += c[k]
        out["launches"][what] = got
        registry.reset_launch_counts()

    def same(what, got, want):
        check(torch.equal(got, want),
              f"parallel {what}: sharded differs from unsharded by "
              f"{(got.float() - want.float()).abs().max().item()}")

    # (a) collectives: exact on integer-valued fp32 over 4 positions
    mesh = default_mesh("x", [dev] * PAR_POSITIONS)
    n = PAR_POSITIONS
    x = torch.arange(n * 8 * 128, dtype=torch.float32,
                     device=dev).reshape(n * 8, 128) % 977
    xs = x.split(8)
    x2 = torch.arange(n * n * 128, dtype=torch.float32,
                      device=dev).reshape(n * n, 128) % 977
    want = {"all_reduce": sum(xs[1:], xs[0]), "all_gather": x,
            "reduce_scatter": sum(xs[1:], xs[0]),
            "ring_permute": torch.cat([xs[(i - 1) % n] for i in range(n)]),
            "all_to_all": x2.reshape(n, n, 128).transpose(0, 1)
            .reshape(n * n, 128),
            "broadcast": xs[3]}
    exact = {}
    for name, op in col._COLLECTIVES.items():
        op = op(mesh, "x", 3) if name == "broadcast" else op(mesh, "x")
        got = op(x2 if name == "all_to_all" else x)
        exact[name] = bool(torch.equal(got, want[name]))
        check(exact[name], f"parallel {name} on {n} positions is not exact")
    out["collectives_exact"] = exact
    registry.reset_launch_counts()

    # (b) sharded flash (B1) == unsharded, bit for bit
    B, T, H, D = 8, 512, 12, 64
    q, k, v, seg = flash_case(dev, "bfloat16", B, T, "segments", gen)
    ref = flash_attention(q, k, v, None, False, segment_ids=seg,
                          layout="bthd")
    registry.reset_launch_counts()
    out["flash"] = {}
    runs = {}
    for dp, tp in PAR_FLASH_MESHES:
        run = runs[dp, tp] = sharded_flash_attention(
            dp_tp_mesh(dp, tp, [dev] * (dp * tp)))
        got = run(q, k, v, seg)
        launched(f"flash_{dp}x{tp}", {"flash_fwd": dp * tp})
        same(f"flash ({dp}, {tp})", got, ref)
        out["flash"][f"{dp}x{tp}"] = {"bit_exact": True}
    timed = {"flash": (runs[2, 2], (q, k, v, seg), lambda *a: flash_attention(
        *a[:3], None, False, segment_ids=a[3], layout="bthd"))}
    mh = sched_mask("mh", T)
    ref = flash_attention(q, k, v, None, False, mask=mh, layout="bthd")
    registry.reset_launch_counts()
    got = sharded_flash_attention(dp_tp_mesh(1, 4, [dev] * 4),
                                  mask=mh)(q, k, v)
    launched("flash_multihead_1x4", {"flash_fwd_sched": 4})
    same("flash MultiHeadMask (1, 4)", got, ref)
    out["flash"]["multihead_1x4"] = {"bit_exact": True}

    # (c) sharded paged (B4, B5) == unsharded, bit for bit
    lens = [0, 1, 77, 128, 129, 300, 511, 512]
    pmesh = dp_tp_mesh(2, 2, [dev] * 4)
    q, kp, vp, bt, sl = paged_case(dev, "bfloat16", lens, 0, gen)
    ref = paged_attention(q, kp, vp, bt, sl)
    registry.reset_launch_counts()
    run = sharded_paged_attention(pmesh)
    got = run(q, kp, vp, bt, sl)
    launched("paged_b4_2x2", {"paged_decode": 4})
    same("paged B4 (2, 2)", got, ref)
    out["paged"] = {"b4": {"bit_exact": True}}
    timed["paged_b4"] = (run, (q, kp, vp, bt, sl), paged_attention)
    q4 = torch.randn(8, SPEC_K, H, D, generator=gen).to(q.dtype).to(dev)
    sl4 = torch.clamp(sl, min=SPEC_K)
    kr = torch.tensor([4, 1, 2, 4, 3, 4, 4, 4], dtype=torch.int32,
                      device=dev)
    ref = paged_attention(q4, kp, vp, bt, sl4, q_rows=kr)
    registry.reset_launch_counts()
    got = run(q4, kp, vp, bt, sl4, q_rows=kr)
    launched("paged_b5_k4_2x2", {"paged_decode_multi": 4})
    same("paged B5 k = 4 (2, 2)", got, ref)
    narrow, po = rolling_table(bt, sl4.tolist(), SPEC_K, WINDOW, 128)
    ref = paged_attention(q4, kp, vp, narrow, sl4, q_rows=kr, window=WINDOW,
                          page_offsets=po)
    registry.reset_launch_counts()
    got = sharded_paged_attention(pmesh, window=WINDOW)(
        q4, kp, vp, narrow, sl4, q_rows=kr, page_offsets=po)
    launched("paged_b5_window_2x2", {"paged_decode_multi": 4})
    same("paged B5 window 128 rolling (2, 2)", got, ref)
    out["paged"]["b5_k4"] = out["paged"]["b5_window_rolling"] = {
        "bit_exact": True}

    # (d) the sharded replicas == their reference(), every request mode
    attn_dims = dict(batch=8, heads=12, seq=512, dim=64)
    be = ShardedAttentionBackend(dp=2, tp=2, device=dev, **attn_dims)
    for seed_ in (1, 2):
        got = be.call({"seed": seed_})
        check(got["devices"] == 4 and got["mesh"] == [2, 2], f"{got}")
        launched("replica_attention", {"flash_fwd": 4})
        want_ = ShardedAttentionBackend.reference({"seed": seed_},
                                                  device=dev, **attn_dims)
        registry.reset_launch_counts()
        check(got["out"].tobytes() == want_.tobytes(),
              "ShardedAttentionBackend differs from its reference()")
    paged_dims = dict(batch=8, heads=12, head_dim=64, page_size=128,
                      pages=64, table_w=4)
    modes = ({"seed": 1}, {"seed": 2, "q_tokens": 4},
             {"seed": 3, "q_tokens": 2, "offsets": True})
    for window in (None, WINDOW):
        be = ShardedPagedDecodeBackend(dp=2, tp=2, window=window,
                                       device=dev, **paged_dims)
        for req in modes:
            got = be.call(dict(req))
            kernel = ("paged_decode" if window is None and
                      "q_tokens" not in req else "paged_decode_multi")
            launched("replica_paged", {kernel: 4})
            want_ = ShardedPagedDecodeBackend.reference(
                req, window=window, device=dev, **paged_dims)
            registry.reset_launch_counts()
            check(got["out"].tobytes() == want_.tobytes(),
                  f"ShardedPagedDecodeBackend {req} window {window} "
                  "differs from its reference()")
    out["replicas"] = {"attention": {**attn_dims, "dp": 2, "tp": 2,
                                     "bytes_equal": True},
                       "paged": {**paged_dims, "dp": 2, "tp": 2,
                                 "modes": [dict(m) for m in modes],
                                 "windows": [None, WINDOW],
                                 "bytes_equal": True}}
    emit({"phase": "parallel", "flash": out["flash"],
          "paged": out["paged"], "replicas": out["replicas"]})
    del be
    torch.cuda.empty_cache()

    # (e) the shard_map data-parallel step against the local fold
    rng = np.random.default_rng(seed + 1)
    ids = torch.as_tensor(rng.integers(0, 30522, (8, 512)), device=dev)
    masked = torch.as_tensor(rng.random((8, 512)) < 0.15, device=dev)
    batch = _mlm_batch(ids, masked)
    arms = {}
    for reduce in ("local", "shard_map"):
        job = bert_dp_job(dev, seed, batch)
        state = job.init_state()
        step_fn = make_dp_train_step(
            job, reduce=reduce, mesh=default_mesh("dp", [dev] * DP_GRAIN)
            if reduce == "shard_map" else None)
        torch.cuda.synchronize()
        registry.reset_launch_counts()
        losses, ms = [], []
        for _ in range(DP_STEPS):
            t0 = time.perf_counter()
            state, m = step_fn(state)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"])
        shards = DP_GRAIN * DP_STEPS
        launched(f"train_dp_{reduce}",
                 {"flash_fwd": 12 * shards, "flash_bwd_dkv": 12 * shards,
                  "flash_bwd_dq": 12 * shards})
        arms[reduce] = {"losses": losses, "step_ms": ms,
                        "params": [p.detach().clone()
                                   for p in state.leaves()]}
        del job, state, step_fn
        torch.cuda.empty_cache()
    loc, sm = arms["local"], arms["shard_map"]
    check(np.allclose(sm["losses"], loc["losses"], rtol=2e-5, atol=0),
          f"shard_map losses {sm['losses']} against local {loc['losses']}")
    worst = max(float(((a.float() - b.float()).abs()
                       / (b.float().abs() + 1e-30)).max())
                for a, b in zip(sm["params"], loc["params"]))
    close = all(torch.allclose(a, b, rtol=2e-5, atol=1e-7)
                for a, b in zip(sm["params"], loc["params"]))
    check(len(sm["params"]) == 199 and close,
          f"shard_map parameters part from the local fold: {worst}")
    out["train_dp_shard_map"] = {
        "mesh": {"dp": DP_GRAIN}, "positions_on": str(dev), "gpu": gpu,
        "losses": sm["losses"], "local_losses": loc["losses"],
        "step_ms": sm["step_ms"], "local_step_ms": loc["step_ms"],
        "params": len(sm["params"]), "rtol": 2e-5,
        "bit_exact_vs_local": bool(
            sm["losses"] == loc["losses"] and
            all(torch.equal(a, b) for a, b in zip(sm["params"],
                                                  loc["params"])))}
    emit({"phase": "parallel", "train_dp_shard_map":
          out["train_dp_shard_map"]})
    del arms, loc, sm
    torch.cuda.empty_cache()

    # (f) ring and Ulysses attention, fp32, forward and gradients
    smesh = make_mesh(MeshSpec.of(sp=4), [dev] * 4)
    atol, rtol = BWD_TOL["float32"]
    out["sequence_parallel"] = {}
    for causal in (False, True):
        q, k, v = (torch.randn(2, PAR_RING_T, H, D, generator=gen)
                   .to(dev).requires_grad_() for _ in range(3))
        do = torch.randn(2, PAR_RING_T, H, D, generator=gen).to(dev)
        mask = (torch.tril(torch.ones(PAR_RING_T, PAR_RING_T,
                                      dtype=torch.bool, device=dev))
                [None, None] if causal else None)
        want_o = dot_product_attention(q, k, v, mask, precision="float32")
        want_g = torch.autograd.grad(want_o, (q, k, v), do)
        for name, make in (("ring", make_ring_attn_fn),
                           ("ulysses", make_ulysses_attn_fn)):
            fn = make(smesh, dp=None, tp=None, causal=causal)
            got_o = fn(q, k, v)
            got_g = torch.autograd.grad(got_o, (q, k, v), do)
            err = (got_o - want_o).abs().max().item()
            check(torch.allclose(got_o, want_o, atol=TOL["flash"]["float32"],
                                 rtol=TOL["flash"]["float32"]),
                  f"{name} causal={causal}: output off by {err}")
            gerr = {}
            for g, w, nm in zip(got_g, want_g, "qkv"):
                gerr[nm] = (g - w).abs().max().item()
                check(torch.allclose(g, w, atol=atol, rtol=rtol),
                      f"{name} causal={causal}: d{nm} off by {gerr[nm]}")
            out["sequence_parallel"][f"{name}_causal{int(causal)}"] = {
                "max_abs_err": err, "grad_max_abs_err": gerr}
    launched("sequence_parallel", {})
    out["sequence_parallel"].update(
        heads=H, head_dim=D, T=PAR_RING_T, sp=4, batch=2,
        dtype="float32", tol=TOL["flash"]["float32"],
        grad_tol=BWD_TOL["float32"])
    emit({"phase": "parallel",
          "sequence_parallel": out["sequence_parallel"]})

    # (g) device times: the sharded calls at (2, 2) beside the unsharded
    # kernel (one card: the positions share it, so no speedup is read
    # here), and the collective sweep's rows
    out["ms"] = {}
    for what, (sharded, args, plain) in timed.items():
        out["ms"][what] = {"sharded_2x2_ms": device_ms(sharded, *args),
                           "unsharded_ms": device_ms(plain, *args),
                           "gpu": gpu}
    import tempfile
    from tosem_tpu_torch.utils.results import read_results
    with tempfile.TemporaryDirectory(prefix="torch_allreduce_") as d:
        rows_csv = os.path.join(d, "allreduce.csv")
        check(cli.main(["--config=allreduce", f"--max_bytes={PAR_SWEEP_MAX}",
                        f"--results_csv={rows_csv}"]) == 0,
              "the allreduce config failed")
        sweep = [{"bench_id": r["bench_id"],
                  "bus_bw_gbps": float(r["value"]),
                  "time_us": r["extra"]["time_us"],
                  "positions": r["extra"]["positions"],
                  "cards": r["extra"]["cards"]}
                 for r in read_results(rows_csv)]
    cards = torch.cuda.device_count()   # the config's default: 4 a card
    check(sweep and all(r["bus_bw_gbps"] > 0 and r["cards"] == cards and
                        r["positions"] == 4 * cards for r in sweep),
          f"allreduce rows {sweep}")
    out["allreduce"] = {"positions": 4 * cards, "cards": cards, "gpu": gpu,
                        "bus": ("one card's memory (no link, no NCCL)"
                                if cards == 1 else "copies between cards, no NCCL"),
                        "rows": sweep}
    registry.reset_launch_counts()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return counts


PP = 4              # pipeline stages (positions of the pp mesh)
PP_MICRO = 4        # microbatches of the 8 x 512 batch: 2 x 512 each
MESH_STEPS = 3      # steps of each mesh train run


def _base_batch(seed, dev, masked_rows=None):
    """The train phase's 8 x 512 batch of random ids from ``seed + 1``
    (labels = ids); ``masked_rows`` gives each row's masked share (else
    15% everywhere)."""
    import numpy as np
    import torch
    B, T = 8, 512
    rng = np.random.default_rng(seed + 1)
    ids = torch.as_tensor(rng.integers(0, 30522, (B, T)), device=dev)
    share = np.full(B, 0.15) if masked_rows is None else \
        np.asarray(masked_rows)
    masked = torch.as_tensor(rng.random((B, T)) < share[:, None],
                             device=dev)
    return _mlm_batch(ids, masked)


def _grad_gaps(got, want):
    """Largest gap over the largest gradient, per tensor, leaving out the
    attention key biases (softmax is blind to a bias shared by every
    key: their gradient is rounding noise) and a tensor the loss never
    reached."""
    return {n: ((got[n] - want[n]).abs().max()
                / want[n].abs().max().clamp_min(1e-30)).item()
            for n in want if not n.endswith("attn.k.b")
            and float(want[n].abs().max()) > 0}


def phase_pipeline(dev, seed):
    """BERT-base as a GPipe pipeline (``models/bert_pipeline.py``) over
    pp = 4 positions on the one card, 3 layers a stage, the 8 x 512 batch
    in 4 microbatches, flash attention. Forward (bf16, dropout off): the
    encodings equal the 12 layers applied in turn to the same
    microbatches bit for bit, and lie within 2e-2 of the largest value of
    the unmicrobatched encoder; B1 launches pp x (M + pp - 1) x 3 = 84 (a
    stage computes at every tick). Gradients (fp32, no TF32): the
    pipelined MLM gradients within 1e-3 of the largest gradient per
    tensor of the sequential model's, where a model with layer 0's query
    projection scaled by 1.1 must break the bound; the backward recomputes
    each stage at its M real ticks, so B1, B2 and B3 launch pp x M x 3 =
    48 each. Times the pipelined forward and forward + backward beside
    the unpipelined encoder (host clock to a sync), and reports the bubble
    share (pp - 1) / (M + pp - 1)."""
    import dataclasses

    import torch
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.models.bert_pipeline import make_bert_pipeline_fn
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.ops.common import precision
    from tosem_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from tosem_tpu_torch.parallel.pipeline import microbatch, unmicrobatch
    from tosem_tpu_torch.train.trainer import cross_entropy_loss
    mesh = make_mesh(MeshSpec.of(pp=PP), [dev] * PP)
    batch = _base_batch(seed, dev)
    ids = batch["ids"]
    attn = flash_attn_fn()
    per = BertConfig.base().layers // PP
    ticks = PP_MICRO + PP - 1
    out = {"phase": "pipeline", "gpu": gpu_line(), "pp": PP,
           "n_micro": PP_MICRO, "layers_per_stage": per, "batch": [8, 512],
           "bubble_share": (PP - 1) / ticks}

    # forward, bf16, dropout off
    model = Bert(dataclasses.replace(BertConfig.base(), dropout=0.0),
                 device=dev, seed=seed)
    fwd = make_bert_pipeline_fn(model, mesh, n_micro=PP_MICRO, attn_fn=attn)
    with torch.no_grad():
        fwd(None, ids)                      # warm-up: the kernels' build
        torch.cuda.synchronize()
        registry.reset_launch_counts()
        got = fwd(None, ids)
        torch.cuda.synchronize()
        fcounts = dict(registry.LAUNCH_COUNTS)
        T = ids.shape[1]
        h = model._embed(ids, torch.arange(T, device=dev)[None])
        seq = []
        for x in microbatch(h, PP_MICRO):
            for layer in model.layers:
                x = layer(x, attn_fn=attn)
            seq.append(x)
        seq = model.ln_out(unmicrobatch(torch.stack(seq)))
        full = model.apply(ids, attn_fn=attn)
    bit = torch.equal(got, seq)
    scale = float(full.float().abs().max())
    err = float((got.float() - full.float()).abs().max())
    out["forward"] = {"equal_to_microbatched_layers": bit,
                      "max_abs_err_vs_encoder": err, "largest": scale,
                      "limit": 2e-2 * scale, "launches": fcounts}
    check(bit, "pipelined encodings differ from the layers applied in turn "
          f"to the same microbatches (max |diff| "
          f"{float((got.float() - seq.float()).abs().max())})")
    check(err <= 2e-2 * scale, f"pipelined encodings vs the encoder: {err} "
          f"beyond 2e-2 of {scale}")
    b1 = PP * ticks * per
    check(fcounts["flash_fwd"] == b1,
          f"pipelined forward: {fcounts['flash_fwd']} B1 launches, "
          f"expected {b1}")

    # times: bf16, the pipelined forward and forward + backward beside the
    # unpipelined encoder
    def fb(run):
        def go():
            for p in model.parameters():
                p.grad = None
            run().float().square().mean().backward()
        return go

    def timed(fn, reps=3):
        fn()
        return min(_timed(fn) for _ in range(reps))
    with torch.no_grad():
        out["forward_ms"] = timed(lambda: fwd(None, ids))
        out["encoder_forward_ms"] = timed(
            lambda: model.apply(ids, attn_fn=attn))
    out["fwd_bwd_ms"] = timed(fb(lambda: fwd(None, ids)))
    out["encoder_fwd_bwd_ms"] = timed(
        fb(lambda: model.apply(ids, attn_fn=attn)))
    del model, fwd, got, seq, full, h
    torch.cuda.empty_cache()

    # gradients, fp32 without TF32
    cfg32 = dataclasses.replace(BertConfig.base(), dtype="float32",
                                precision="float32", dropout=0.0)

    def grads(run, m):
        for p in m.parameters():
            p.grad = None
        with precision("float32"):
            enc = run()
            loss = cross_entropy_loss(m.mlm_logits(enc), batch["labels"],
                                      batch["masked"])
            loss.backward()
        torch.cuda.synchronize()
        return {n: p.grad.detach().clone() for n, p in m.named_parameters()
                if p.grad is not None}
    m32 = Bert(cfg32, device=dev, seed=seed)
    fwd32 = make_bert_pipeline_fn(m32, mesh, n_micro=PP_MICRO, attn_fn=attn)
    want = grads(lambda: m32.apply(ids, attn_fn=attn), m32)
    registry.reset_launch_counts()
    with precision("float32"):
        enc = fwd32(None, ids)
    torch.cuda.synchronize()
    gf = dict(registry.LAUNCH_COUNTS)
    registry.reset_launch_counts()
    for p in m32.parameters():
        p.grad = None
    with precision("float32"):
        cross_entropy_loss(m32.mlm_logits(enc), batch["labels"],
                           batch["masked"]).backward()
    torch.cuda.synchronize()
    gb = dict(registry.LAUNCH_COUNTS)
    got_g = {n: p.grad.detach().clone() for n, p in m32.named_parameters()
             if p.grad is not None}
    with torch.no_grad():
        m32.layers[0].attn.q.w.mul_(1.1)
    wrong = grads(lambda: m32.apply(ids, attn_fn=attn), m32)
    del m32, fwd32, enc
    torch.cuda.empty_cache()
    gaps = _grad_gaps(got_g, want)
    wrong_gaps = _grad_gaps(wrong, want)
    out["grads_fp32"] = {
        "limit": 1e-3, "max_gap": max(gaps.values()),
        "worst": max(gaps, key=gaps.get),
        "wrong_model_max_gap": max(wrong_gaps.values()),
        "tensors": len(gaps), "launches_forward": gf,
        "launches_backward": gb}
    check(max(gaps.values()) <= 1e-3,
          f"pipelined fp32 gradients beyond 1e-3: {out['grads_fp32']}")
    check(max(wrong_gaps.values()) > 1e-3,
          f"the gradient check cannot see the wrong model: "
          f"{out['grads_fp32']}")
    b_real = PP * PP_MICRO * per
    check(gf["flash_fwd"] == b1, f"fp32 pipelined forward: {gf}")
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        check(gb[name] == b_real,
              f"pipelined backward: {gb[name]} {name} launches, expected "
              f"{b_real}")
    emit(out)
    return {k: fcounts.get(k, 0) + gf.get(k, 0) + gb.get(k, 0)
            for k in KERNELS}


def _mesh_gaps(got, want):
    """Largest gap over the largest value, per tensor (key biases left
    out: see _grad_gaps)."""
    return {n: ((got[n].float() - want[n].float()).abs().max()
                / want[n].float().abs().max().clamp_min(1e-30)).item()
            for n in want if not n.endswith("attn.k.b")}


def phase_mesh_train(dev, seed):
    """Global-batch training over a device mesh on the one card:
    ``make_partitioned_train_step`` with ``bert_rules``/``seq_batch_rules``
    over (dp, tp, sp) = (2, 2, 2) and ``make_train_step(mesh=)`` over dp
    = 4, each 3 steps of BERT-base on the train phase's 8 x 512 batch
    with dropout 0.1 drawn from ``step_generator(seed, i)``, whose rows
    are masked at 40% (rows 0-3) and 5% (rows 4-7), so a mean of the dp
    shards' means is another loss. In fp32 without TF32 under
    SGD(lr=1e-2), losses and parameters within 1e-3 of the largest value
    per tensor of the unsharded ``make_train_step`` (key biases left
    out), where the mean of the dp shards' means must break that bound;
    under adamw(1e-4) the (2, 2, 2) gap is reported. In bf16 (the train
    phase's dtype, adamw(1e-4)): a mesh of one position equals the
    unsharded step bit for bit; after every step each parameter's blocks keep the rule's
    layout and the positions hold their blocks and moments only; B1, B2
    and B3 launch 12 a position a step; step ms and peak memory beside
    the unsharded step."""
    import dataclasses
    import functools
    import gc

    import numpy as np
    import torch
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.ops.common import precision
    from tosem_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from tosem_tpu_torch.parallel.sharding import (bert_rules,
                                                   seq_batch_rules,
                                                   spec_for_path)
    from tosem_tpu_torch.train import (adamw, create_train_state,
                                       make_partitioned_train_step,
                                       make_train_step, mlm_loss,
                                       shard_batch, shard_batch_by_rules,
                                       shard_train_state)
    from tosem_tpu_torch.train.trainer import step_generator
    batch = _base_batch(seed, dev, masked_rows=[0.4] * 4 + [0.05] * 4)
    counts = batch["masked"].sum(1).tolist()
    loss_fn = functools.partial(mlm_loss, attn_fn=flash_attn_fn())
    out = {"phase": "mesh_train", "gpu": gpu_line(), "steps": MESH_STEPS,
           "batch": [8, 512], "masked_per_row": counts}

    def run(kind, cfg, opt=adamw(1e-4)):
        """(losses, full parameters, ms a step, launches, peak GiB, what
        the positions hold between steps)."""
        m = Bert(cfg, device=dev, seed=seed)
        st = create_train_state(m, opt)
        b = batch
        if kind == "plain":
            step = make_train_step(m, st.optimizer, loss_fn)
        elif kind == "mean_of_means":
            def mom(model, bb, generator=None):
                parts = [loss_fn(model, {k: v[i:i + 2] for k, v in
                                         bb.items()}, generator)[0]
                         for i in range(0, 8, 2)]
                return torch.stack(parts).mean(), {}
            step = make_train_step(m, st.optimizer, mom)
        elif kind in ("dp4", "one_dp"):
            n = 4 if kind == "dp4" else 1
            mesh = make_mesh(MeshSpec.of(dp=n), [dev] * n)
            step = make_train_step(m, st.optimizer, loss_fn, mesh=mesh)
            b = shard_batch(batch, mesh)
        else:
            shape = dict(dp=2, tp=2, sp=2) if kind == "dp_tp_sp" \
                else dict(dp=1, tp=1, sp=1)
            n = int(np.prod(list(shape.values())))
            mesh = make_mesh(MeshSpec.of(**shape), [dev] * n)
            st = shard_train_state(st, mesh, bert_rules())
            step = make_partitioned_train_step(
                m, None, loss_fn, mesh=mesh, rules=bert_rules(),
                batch_rules=seq_batch_rules())
            b = shard_batch_by_rules(batch, mesh, seq_batch_rules())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        registry.reset_launch_counts()
        gc.collect()
        earlier = {id(t) for t in big_cuda_tensors()}
        losses, ms = [], []
        for i in range(MESH_STEPS):
            t0 = time.perf_counter()
            with precision(cfg.precision):
                st, met = step(st, b, step_generator(seed, i, dev))
            losses.append(float(met["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            if hasattr(st, "blocks"):
                layout(kind, st)
        launches = dict(registry.LAUNCH_COUNTS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        resident = None
        if hasattr(st, "blocks"):
            # between steps the positions hold their blocks and moments:
            # no other device tensor of a MiB or more is reachable (the
            # allocator's total also holds what no Python object owns,
            # cuBLAS's workspace for each handle a position thread took,
            # so it is reported beside the sum of the known tensors)
            torch.cuda.synchronize()
            held = [p for bl in st.blocks.values() for p in bl.pieces]
            moments = [v for o in st.optimizers.pieces
                       for s_ in o.state.values() for v in s_.values()
                       if torch.is_tensor(v)]
            known = held + moments + list(m.parameters()) + \
                list(batch.values()) + [p for v in b.values()
                                        for p in v.pieces]
            ids = {id(t) for t in known} | earlier
            gc.collect()
            stray = [t for t in big_cuda_tensors() if id(t) not in ids]

            def nbytes(ts):
                return sum(t.numel() * t.element_size() for t in ts
                           if t.is_cuda)
            resident = {"allocated": torch.cuda.memory_allocated(),
                        "blocks": nbytes(held), "moments": nbytes(moments),
                        "model": nbytes(m.parameters()),
                        "stray_tensors": len(stray),
                        "stray_bytes": nbytes(stray)}
            check(not stray, f"{kind}: positions hold more than their "
                  f"blocks between steps: {resident}, shapes "
                  f"{[tuple(t.shape) for t in stray][:8]}")
            params = {k: v.cpu() for k, v in st.gather().items()}
        else:
            params = {n: p.detach().cpu() for n, p in m.named_parameters()}
        del st, step, m
        torch.cuda.empty_cache()
        return losses, params, ms, launches, peak, resident

    def big_cuda_tensors():
        return [t for t in gc.get_objects()
                if torch.is_tensor(t) and t.is_cuda
                and t.numel() * t.element_size() >= 1 << 20]

    def layout(kind, st):
        for name, bl in st.blocks.items():
            spec = tuple(spec_for_path(name, bert_rules()))[:bl.pieces[0]
                                                              .ndim]
            check(tuple(bl.spec) == spec, f"{kind}: {name} held as "
                  f"{bl.spec}, rule {spec}")
            full = st.model.get_parameter(name).shape
            for i, p in enumerate(bl.pieces):
                want = list(full)
                for d, e in enumerate(bl.spec):
                    if e is not None:
                        want[d] //= st.mesh.shape[e]
                check(list(p.shape) == want and p.grad is None,
                      f"{kind}: position {i} holds {name} as "
                      f"{tuple(p.shape)}, grad {p.grad is not None}")

    # fp32 without TF32: the global step against the unsharded one, under
    # SGD, whose parameters move by the gradients themselves. Under adamw
    # a zero-initialised bias whose gradient sits at the rounding floor
    # takes a step set by that rounding (|g| near eps = 1e-8), so its
    # gap is reported beside, not held
    cfg32 = dataclasses.replace(BertConfig.base(), dtype="float32",
                                precision="float32")
    sgd = functools.partial(torch.optim.SGD, lr=1e-2)
    out["fp32"] = {"optimizer": "SGD(lr=1e-2)"}
    for opt_name, opt, kinds in (
            ("sgd", sgd, ("dp_tp_sp", "dp4", "mean_of_means")),
            ("adamw", adamw(1e-4), ("dp_tp_sp",))):
        ref = run("plain", cfg32, opt)
        rec = out["fp32"][opt_name] = {"plain_losses": ref[0]}
        for kind in kinds:
            got = run(kind, cfg32, opt)
            gaps = _mesh_gaps(got[1], ref[1])
            lgap = max(abs(a - b) / abs(b) for a, b in zip(got[0], ref[0]))
            rec[kind] = {"losses": got[0], "loss_gap": lgap,
                         "param_gap_max": max(gaps.values()),
                         "worst": max(gaps, key=gaps.get)}
            if opt_name == "adamw":
                continue
            inside = lgap <= 1e-3 and max(gaps.values()) <= 1e-3
            check(inside if kind != "mean_of_means" else not inside,
                  f"fp32 {kind} against the unsharded step: {rec[kind]}")
        del ref
    # bf16: the bit pin, layout, launches, times, memory
    cfg = BertConfig.base()
    plain = run("plain", cfg)
    out["bf16"] = {"plain": {"losses": plain[0], "step_ms": plain[2],
                             "peak_gib": plain[4]}}
    launches = {k: 0 for k in KERNELS}
    for kind, positions in (("one", 1), ("one_dp", 1), ("dp_tp_sp", 8),
                            ("dp4", 4)):
        got = run(kind, cfg)
        rec = {"losses": got[0], "step_ms": got[2], "peak_gib": got[4],
               "launches": got[3]}
        if kind.startswith("one"):
            same = got[0] == plain[0] and all(
                torch.equal(got[1][n], plain[1][n]) for n in plain[1])
            rec["equal_to_unsharded"] = same
            check(same, f"bf16 {kind}: a one-position mesh differs from "
                  "the unsharded step")
        else:
            gaps = _mesh_gaps(got[1], plain[1])
            rec["loss_gap"] = max(abs(a - b) / abs(b)
                                  for a, b in zip(got[0], plain[0]))
            rec["param_gap_max"] = max(gaps.values())
            check(rec["loss_gap"] <= 1e-3,
                  f"bf16 {kind} loss against the unsharded step: {rec}")
        if got[5] is not None:
            rec["resident"] = got[5]
        for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
            want = cfg.layers * positions * MESH_STEPS
            check(got[3][name] == want, f"bf16 {kind}: {got[3][name]} "
                  f"{name} launches, expected {want}")
        for k in KERNELS:
            launches[k] += got[3].get(k, 0)
        out["bf16"][kind] = rec
    emit(out)
    return launches


# ------------------------------------------------------------------ benches

# (a) the page sweep's shapes (the JAX package's on-chip defaults of its
# autotune_decode_pages, tosem_tpu/cli.py:604-610) and the spec leg's
# shape for the q sweep: 8 sequences of BERT-base's 12 heads of 64
AUTOTUNE_PAGE_SHAPES = ((8, 12, 512, 64, "bfloat16"),
                        (8, 12, 2048, 64, "bfloat16"),
                        (16, 12, 1024, 64, "bfloat16"))
AUTOTUNE_SPEC_SHAPES = ((8, 12, 512, 64, "bfloat16"),)
BENCH_MIN_S = 0.2       # (b) the decode bench's closed-loop windows
CLUSTER_BENCH_MIN_S = 0.1   # (d) run_cluster_benchmarks' windows
DP_NODES_WORLD = 4      # (c) ranks, one a node agent


def dp_job(seed, device="cuda"):
    """The train_dp phase's BERT-base job, built from JSON kwargs: what
    a rank replica builds from ``"chip_smoke:dp_job"`` (this module's top
    level loads the standard library only). The batch is the train_dp
    phase's, drawn from ``seed + 1`` in the same order."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed + 1)
    ids = torch.as_tensor(rng.integers(0, 30522, (8, 512)), device=device)
    masked = torch.as_tensor(rng.random((8, 512)) < 0.15, device=device)
    return bert_dp_job(device, seed, _mlm_batch(ids, masked))


def bench_replica_classes():
    """The decode bench's two deployed backends, each adding the
    replica's launch counts and process id to ``stats()`` and setting
    the counts to 0 as its warm-up ends (the backends' own warm-ups
    build step callables only). Defined in a function, so cloudpickle
    ships them by value to the spawned replicas."""
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    from tosem_tpu_torch.serve.bench_decode import NaiveRecodeBackend

    def counted(base):
        class Counted(base):
            def warmup(self, shapes):
                import torch
                out = super().warmup(shapes)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                reset_counts()
                return out

            def stats(self):
                return replica_stats(super().stats())
        Counted.__name__ = Counted.__qualname__ = f"Counted{base.__name__}"
        return Counted
    return {"decode": counted(BertDecodeBackend),
            "naive": counted(NaiveRecodeBackend)}


def benches_autotune(dev, out):
    """(a) The decode half of block selection on the card: the page
    sweep (B4) and the speculative q sweep (B5) into a temporary cache,
    the selectors reading the winners back from it, and a BERT-base
    decode backend built over it running at the cached page."""
    import tempfile
    import torch
    from tosem_tpu_torch.ops import flash_blocks as fb
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_autotune_") as tmp:
        # the backend reads the default cache, relative to the working
        # directory: run this leg from a temporary one
        os.chdir(tmp)
        try:
            cache = fb.DEFAULT_CACHE_PATH
            fb.reset_cache()
            registry.reset_launch_counts()
            pages = fb.autotune_decode_pages(AUTOTUNE_PAGE_SHAPES, reps=3,
                                             cache_path=cache, device=dev)
            qs = fb.autotune_spec_q(AUTOTUNE_SPEC_SHAPES, reps=3,
                                    cache_path=cache, device=dev)
            swept = dict(registry.LAUNCH_COUNTS)
            fb.reset_cache()
            page = fb.select_page_size(64, "bfloat16", cache_path=cache,
                                       platform="cuda")
            page_src = fb.select_page_size.last_source
            q = fb.select_spec_q(64, "bfloat16", cache_path=cache,
                                 platform="cuda")
            q_src = fb.select_spec_q.last_source
            # a decode backend over that cache, at BERT-base's max_len
            want_be = fb.select_page_size(64, "bfloat16", max_len=512,
                                          cache_path=cache, platform="cuda")
            be = BertDecodeBackend(preset="base", max_batch=8,
                                   num_pages=64, device=dev)
            be_src = fb.select_page_size.last_source
            stream = be.call({"ids": list(range(1, 200)),
                              "max_new_tokens": 4})["generated"]
            be_page = (be.page_size, be.cache.page_size)
            del be
            torch.cuda.empty_cache()
        finally:
            os.chdir(cwd)
            fb.reset_cache()
    check(swept["paged_decode"] > 0 and swept["paged_decode_multi"] > 0,
          f"autotune: B4/B5 never launched ({swept})")
    check(all(r["platform"] == "cuda" and r["backend"] == "cuda"
              for r in pages + qs), "autotune: a sweep ran off the card")
    want_page = next(r["page"] for r in pages if r["best"])
    want_q = next(r["k"] for r in qs if r["best"])
    check((page, page_src) == (want_page, "cache"),
          f"autotune: select_page_size read {page} from {page_src}, the "
          f"sweep's winner is {want_page}")
    check((q, q_src) == (want_q, "cache"),
          f"autotune: select_spec_q read {q} from {q_src}, the sweep's "
          f"winner is {want_q}")
    check(be_page == (want_be, want_be) and be_src == "cache",
          f"autotune: the backend runs at page {be_page} ({be_src}), the "
          f"cache says {want_be}")
    check(len(stream) == 4, f"autotune: backend stream {stream}")
    launches = {k: n for k, n in registry.LAUNCH_COUNTS.items() if n}
    out["autotune"] = {
        "pages_us": {f"b{r['shape'][0]}_t{r['shape'][2]}_p{r['page']}":
                     r["time_us"] for r in pages},
        "page_winners": {f"b{r['shape'][0]}_t{r['shape'][2]}": r["page"]
                         for r in pages if r["best"]},
        "spec_q_us": {f"k{r['k']}": r["time_us"] for r in qs},
        "spec_q_per_token_us": {f"k{r['k']}": r["per_token_us"]
                                for r in qs},
        "cached_page": page, "cached_spec_q": q,
        "backend_page": want_be, "launches": launches}
    emit({"phase": "benches", "leg": "autotune", "gpu": out["gpu"],
          **out["autotune"]})
    return launches


def benches_decode(dev, out):
    """(b) Every leg of the decode bench once at BERT-base: its answer
    checks raise inside the bench; B1, B4 and B5 must launch, read inside
    the replicas and in this process (the window and prefix legs run
    here); no replica may outlive the bench."""
    import torch
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.serve.bench_decode import run_decode_benchmarks
    torch.cuda.empty_cache()
    reset_counts()
    stats = []
    t0 = time.perf_counter()
    rows = run_decode_benchmarks(trials=1, min_s=BENCH_MIN_S, quiet=True,
                                 preset="base", device=dev,
                                 backends=bench_replica_classes(),
                                 replica_stats=stats)
    secs = time.perf_counter() - t0
    here = dict(registry.LAUNCH_COUNTS)
    registry.reset_launch_counts()
    torch.cuda.empty_cache()
    by_dep = {s["deployment"]: {k: n for k, n in s["launch_counts"].items()
                                if n} for s in stats}
    total = {k: here[k] + sum(s["launch_counts"][k] for s in stats)
             for k in KERNELS}
    pids = {s["pid"] for s in stats}
    deadline = time.perf_counter() + 30
    while time.perf_counter() < deadline and any(
            pid_state(p) == "alive" for p in pids):
        time.sleep(0.2)
    by_id = {r.bench_id: r for r in rows}
    out["decode_bench"] = {
        "seconds": secs, "min_s": BENCH_MIN_S, "trials": 1,
        "rows": {b: {"value": r.value, "unit": r.unit,
                     **{k: r.extra[k] for k in
                        ("reference_floor", "floor_met", "live_pages_per_seq",
                         "live_pages_bound", "pages_evicted",
                         "acceptance_rate", "prefix_hit_rate",
                         "calls_per_round") if k in r.extra}}
                 for b, r in by_id.items()},
        "launches_in_process": {k: n for k, n in here.items() if n},
        "launches_by_replica": by_dep,
        "replica_pids": {p: pid_state(p) for p in sorted(pids)}}
    emit({"phase": "benches", "leg": "decode_bench", "gpu": out["gpu"],
          **out["decode_bench"]})
    check(len(stats) == 6, f"decode bench: {len(stats)} replicas reported")
    for p in pids:
        check(pid_state(p) != "alive", f"decode bench replica {p} outlived "
              "the bench")
    check(here["paged_decode"] > 0 and here["paged_decode_multi"] > 0,
          f"decode bench: the window leg's B4/B5 never launched ({here})")
    for dep, names in (("bench-decode", ("flash_fwd", "paged_decode")),
                       ("bench-recode", ("flash_fwd",)),
                       ("bench-spec", ("flash_fwd", "paged_decode_multi")),
                       ("bench-prefix-sess", ("paged_decode_multi",))):
        for k in names:
            check(by_dep.get(dep, {}).get(k, 0) > 0,
                  f"decode bench: {k} never launched in {dep}")
    return total


def benches_dp_nodes(dev, seed, out):
    """(c) The train_dp phase's BERT-base job over node agents: ranks as
    replica processes (``DistributedTrainer(backend="nodes")``), each
    building ``"chip_smoke:dp_job"`` on the card, against the threads
    backend and the local fold bit for bit, then again with one rank's
    agent SIGKILLed after step 1, against a threads run that loses its
    last rank at the same step. B1-B3 launch 12 a shard computed inside
    each rank."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    import torch
    from tosem_tpu_torch.cluster.node import RemoteNode
    from tosem_tpu_torch.cluster.rpc import RpcClient
    from tosem_tpu_torch.cluster.supervisor import HeadJournal, NodePool
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.train.distributed import (DataParallelConfig,
                                                   DistributedTrainer,
                                                   make_dp_train_step)
    flash = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    torch.cuda.empty_cache()
    job = dp_job(seed, dev)
    state = job.init_state()
    step_fn = make_dp_train_step(job)
    ref_losses = []
    for _ in range(DP_STEPS):
        state, m = step_fn(state)
        ref_losses.append(m["loss"])
    ref_params = [p.detach().clone() for p in state.leaves()]
    del state, step_fn
    registry.reset_launch_counts()
    rec = {"world": DP_NODES_WORLD, "steps": DP_STEPS,
           "local_fold_losses": ref_losses, "runs": {}}
    counts = {k: 0 for k in KERNELS}
    pids = set()

    def same(tr):
        got = tr.fetch_state().leaves()
        return len(got) == len(ref_params) and all(
            torch.equal(a, b) for a, b in zip(got, ref_params))

    def timed_fit(tr, kill_after=None):
        marks = []

        def on_step(done, _):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if done == kill_after:
                victim = tr._workers[-1]
                if tr.backend == "nodes":
                    victim.node.kill()
                else:
                    victim.dead = True
        t0 = time.perf_counter()
        losses = tr.fit(DP_STEPS, on_step=on_step)
        return losses, [(b - a) * 1e3 for a, b in
                        zip([t0] + marks[:-1], marks)]

    def threads_run(what, kill_after=None):
        cfg = DataParallelConfig(job=f"bench-{what}", **DP_CFG)
        torch.cuda.synchronize()
        with DistributedTrainer(job=job, cfg=cfg,
                                world=DP_NODES_WORLD) as tr:
            losses, ms = timed_fit(tr, kill_after)
            params = [p.detach().clone()
                      for p in tr.fetch_state().leaves()]
            world = tr.world
        registry.reset_launch_counts()
        rec["runs"][what] = {"losses": losses, "step_ms": ms,
                             "world_after": world}
        return losses, params

    def nodes_trainer(what, pool):
        """(trainer, seconds to start it): the ranks build the job from
        its ref; the trainer's own copy (templates only) is this
        process's job."""
        t0 = time.perf_counter()
        tr = DistributedTrainer(
            "chip_smoke:dp_job", {"seed": seed, "device": str(dev)},
            DataParallelConfig(job=f"bench-{what}", **DP_CFG),
            backend="nodes", world=DP_NODES_WORLD, pool=pool, job=job)
        return tr, time.perf_counter() - t0

    def nodes_run(what, started, journal, kill_after=None):
        tr, spawn_s = started
        cfg = tr.cfg
        with tr:
            for h in tr._workers:
                with RpcClient(h.address, call_timeout=30.0) as cli:
                    pids.add(cli.call("health")["pid"])
            losses, ms = timed_fit(tr, kill_after)
            t1 = time.perf_counter()
            params = [p.detach().clone()
                      for p in tr.fetch_state().leaves()]
            fetch_s = time.perf_counter() - t1
            ranks = [h.call("stats") for h in tr._workers]
            stats = tr.stats()
            t1 = time.perf_counter()
        close_s = time.perf_counter() - t1
        torch.cuda.empty_cache()
        for r in ranks:
            for k in flash:
                check(r["launch_counts"][k] == 12 * r["shard_grads"],
                      f"dp nodes {what}: rank {r['rank']} launched {k} "
                      f"{r['launch_counts'][k]} times for "
                      f"{r['shard_grads']} shards")
            for k in counts:
                counts[k] += r["launch_counts"][k]
        events = [e["event"] for e in HeadJournal.load(journal)
                  if e.get("job") == cfg.job]
        rec["runs"][what] = {
            "losses": losses, "step_ms": ms, "spawn_s": spawn_s,
            "startup_s": stats["startup_s"], "fetch_s": fetch_s,
            "close_s": close_s,
            "world_after": stats["world"], "shrinks": stats["shrinks"],
            "rank_shards": [r["shard_grads"] for r in ranks],
            "rank_launches": [{k: r["launch_counts"][k] for k in flash}
                              for r in ranks],
            "journal": events}
        return losses, params, stats, events

    tmp = tempfile.TemporaryDirectory(prefix="chip_dp_nodes_")
    journal = os.path.join(tmp.name, "head.jsonl")
    pool = NodePool(journal_path=journal, miss_threshold=1,
                    probe_timeout=3.0)
    try:
        with ThreadPoolExecutor(DP_NODES_WORLD) as ex:
            agents = list(ex.map(lambda _: RemoteNode.spawn_local(
                num_workers=1), range(DP_NODES_WORLD)))
        for i, node in enumerate(agents):
            pool.add_node(node, name=f"t{i}")
        n_losses, n_params, n_stats, n_events = nodes_run(
            "nodes", nodes_trainer("nodes", pool), journal)
        t_losses, t_params = threads_run("threads")
        check(n_losses == t_losses == ref_losses,
              f"dp nodes: losses {n_losses}, threads {t_losses}, local "
              f"fold {ref_losses}")
        check(all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in
                  zip(n_params, t_params, ref_params))
              and len(n_params) == len(t_params) == len(ref_params),
              "dp nodes: final parameters differ from the threads "
              "backend's or the local fold's")
        check(n_events.count("train_worker_placed") == DP_NODES_WORLD
              and "train_started" in n_events,
              f"dp nodes: journal {n_events}")
        # the second gang starts while the shrunk threads run (whose
        # time is not reported) steps
        with ThreadPoolExecutor(1) as ex:
            starting = ex.submit(nodes_trainer, "nodes_killed", pool)
            s_losses, s_params = threads_run("threads_shrunk",
                                             kill_after=1)
            started = starting.result()
        k_losses, k_params, k_stats, k_events = nodes_run(
            "nodes_killed", started, journal, kill_after=1)
        check(k_stats["world"] == DP_NODES_WORLD - 1
              and k_stats["shrinks"] == 1,
              f"dp nodes killed: no shrink to {DP_NODES_WORLD - 1}: "
              f"{k_stats}")
        check("train_worker_lost" in k_events
              and "train_shrunk" in k_events,
              f"dp nodes killed: journal {k_events}")
        check(k_losses == s_losses == ref_losses,
              f"dp nodes killed: losses {k_losses}, threads shrunk "
              f"{s_losses}, local fold {ref_losses}")
        check(all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in
                  zip(k_params, s_params, ref_params))
              and len(k_params) == len(s_params) == len(ref_params),
              "dp nodes killed: final parameters differ from the shrunk "
              "threads run's or the local fold's")
    finally:
        pool.close(close_nodes=True)
        tmp.cleanup()
    del job
    torch.cuda.empty_cache()
    deadline = time.perf_counter() + 30
    while time.perf_counter() < deadline and any(
            pid_state(p) == "alive" for p in pids):
        time.sleep(0.2)
    rec["rank_pids"] = {p: pid_state(p) for p in sorted(pids)}
    rec["step_ms_nodes"] = float(np.mean(rec["runs"]["nodes"]["step_ms"][1:]))
    rec["step_ms_threads"] = float(np.mean(
        rec["runs"]["threads"]["step_ms"][1:]))
    rec["launches"] = {k: n for k, n in counts.items() if n}
    rec["bit_exact"] = True
    out["dp_nodes"] = rec
    emit({"phase": "benches", "leg": "dp_nodes", "gpu": out["gpu"], **rec})
    for p in pids:
        check(pid_state(p) != "alive", f"dp rank {p} outlived its trainer")
    for k in flash:
        check(counts[k] > 0, f"dp nodes: {k} never launched in a rank")
    return counts


def benches_cluster(dev, out):
    """(d) The cluster bench (``run_cluster_benchmarks``, the CLI's
    ``cluster_bench``) once at the JAX package's sizes, its model
    replicas on the card: one round of ``CLUSTER_BENCH_MIN_S`` windows
    (the CLI runs 2 of 0.4 s). Its answer checks raise inside."""
    import torch
    from tosem_tpu_torch.serve.bench_cluster import run_cluster_benchmarks
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows = run_cluster_benchmarks(trials=1, min_s=CLUSTER_BENCH_MIN_S,
                                  quiet=True, device=dev)
    out["cluster_bench"] = {
        "seconds": time.perf_counter() - t0, "trials": 1,
        "min_s": CLUSTER_BENCH_MIN_S,
        "rows": {r.bench_id: {"value": r.value, "unit": r.unit,
                              **{k: r.extra[k] for k in
                                 ("reference_floor", "reference_ceiling_ms",
                                  "floor_met", "kv_migrations",
                                  "hedges_fired", "raw_recovery")
                                 if k in r.extra}} for r in rows}}
    emit({"phase": "benches", "leg": "cluster_bench", "gpu": out["gpu"],
          **out["cluster_bench"]})
    want = {"cluster_failover_errors", "cluster_sharded_parity",
            "cluster_paged_parity", "router_hedged_p99",
            "cluster_decode_disagg_c16", "cluster_drain_migrate_vs_readmit"}
    missing = want - set(out["cluster_bench"]["rows"])
    check(not missing, f"cluster bench: rows missing {sorted(missing)}")


def phase_benches(dev, seed):
    """The benches phase: (a) the decode autotune round trip, (b) the
    decode bench at BERT-base, (c) data-parallel BERT-base over node
    agents, (d) the cluster bench. Returns the kernels' launch counts of
    (a)-(c) (the cluster bench's replicas are the cluster phase's
    backends, whose launches that phase reads)."""
    t_phase = time.perf_counter()
    out = {"phase": "benches", "gpu": gpu_line()}
    secs = {}
    counts = {k: 0 for k in KERNELS}
    for name, fn, args in (("autotune", benches_autotune, (dev, out)),
                           ("decode_bench", benches_decode, (dev, out)),
                           ("dp_nodes", benches_dp_nodes, (dev, seed, out)),
                           ("cluster_bench", benches_cluster, (dev, out))):
        t = time.perf_counter()
        got = fn(*args) or {}
        secs[name] = time.perf_counter() - t
        emit({"phase": "benches", "leg": name, "seconds": secs[name]})
        for k, n in got.items():
            counts[k] += n
    emit({"phase": "benches", "gpu": out["gpu"], "seconds": secs,
          "total_s": time.perf_counter() - t_phase,
          "launches": {k: n for k, n in counts.items() if n}})
    return counts


CONFIG_CHECK_BATCH = 32    # the ResNet card-vs-CPU step's batch
S2D_REL = 1e-5             # s2d stem vs conv1, of the largest output
RESNET_REL = 1e-3          # card vs CPU ResNet step, of the largest value
# card vs CPU, each parameter's update (the step's gradient) in relative
# L2 norm. An fp32 step on the CPU against the same step in fp64 reads
# 1.5e-3 at most; a weight before a BatchNorm scaled by 1.1 (the
# yardstick) reads 0.091 on that weight. Element-wise maxima are no
# measure here: BatchNorm's backward subtracts a mean, and on a conv
# weight fp32 against fp64 already read 1.0e-2.
RESNET_UPDATE_REL = 1e-2
RESNET_TRACED = 3          # ResNet-50 steps resnet_train --profile traces


def resnet_step(where, init, batch, wrong=False):
    """One SGD step (lr 0.1, momentum 0.9) of fp32 ``resnet18_ish``
    (TF32 off) from ``init`` on ``batch``: (eval logits before the step,
    the step's loss, the BatchNorm moving stats after it, each
    parameter's update, all on the CPU). ``wrong`` scales block 0's 3x3
    kernel by 1.1 first: the yardstick. A BatchNorm follows that conv,
    so in training the loss and every other gradient are unchanged and
    that weight's gradient shrinks by 1/1.1."""
    import torch
    from tosem_tpu_torch.models.resnet import resnet18_ish
    from tosem_tpu_torch.ops.common import precision
    from tosem_tpu_torch.train import (classification_loss,
                                       create_train_state, make_train_step)
    m = resnet18_ish(num_classes=10, dtype=torch.float32,
                     precision="float32", device=where)
    m.load_state_dict(init)
    if wrong:
        with torch.no_grad():
            m.blocks[0].conv2.w.mul_(1.1)
    start = {k: v.detach().clone() for k, v in m.named_parameters()}
    st = create_train_state(m, lambda p: torch.optim.SGD(p, lr=0.1,
                                                         momentum=0.9))
    step = make_train_step(m, st.optimizer, classification_loss)
    b = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
    with precision("float32"):
        with torch.no_grad():
            logits = m(b["image"]).cpu()
        st, met = step(st, b)
    return (logits, float(met["loss"]),
            {k: v.detach().cpu() for k, v in m.named_buffers()},
            {k: (v.detach() - start[k]).cpu()
             for k, v in m.named_parameters()})


def _rel(g, w):
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def resnet_gaps(got, want):
    """The logits' and every BatchNorm moving stat's max |got - want|
    over max |want| (the largest stat), the loss's relative gap, and
    each parameter's update's ||got - want|| / ||want|| (the largest,
    and the parameter that has it)."""
    ups = {k: float((got[3][k] - w).norm() / w.norm().clamp_min(1e-30))
           for k, w in want[3].items()}
    worst = max(ups, key=ups.get)
    return {"logits": _rel(got[0], want[0]),
            "loss": abs(got[1] - want[1]) / abs(want[1]),
            "bn_stats": max(_rel(got[2][k], w) for k, w in want[2].items()),
            "updates": ups[worst], "updates_worst": worst}


def resnet_held(g):
    """Whether a gap set is within the limits: the forward quantities
    within RESNET_REL, the updates within RESNET_UPDATE_REL."""
    return (max(g["logits"], g["loss"], g["bn_stats"]) <= RESNET_REL,
            g["updates"] <= RESNET_UPDATE_REL)


def phase_configs(dev, seed):
    """North-star configs 1, 2 and 4 on the card through the port's
    experiment runner, then the space-to-depth stem and the ResNet step
    against the CPU (see the module docstring)."""
    import csv
    import tempfile

    import numpy as np
    import torch
    from tosem_tpu_torch import cli
    from tosem_tpu_torch.data.synthetic import cifar_like_batches
    from tosem_tpu_torch.models.resnet import resnet18_ish
    from tosem_tpu_torch.ops import conv
    from tosem_tpu_torch.utils.results import read_results
    from tosem_tpu_torch.utils.roofline import peak_gflops
    gpu = gpu_line()
    out = {"gpu": gpu}
    with tempfile.TemporaryDirectory(prefix="torch_configs_") as d:
        path = os.path.join(d, "configs.csv")
        for config in ("gemm", "timing_check", "conv_sweep",
                       "resnet_train"):
            t = time.perf_counter()
            extra = ["--profile"] if config == "resnet_train" else []
            check(cli.main([f"--config={config}", *extra,
                            f"--results_csv={path}"]) == 0,
                  f"the {config} config failed")
            out[f"{config}_s"] = time.perf_counter() - t
        rows = read_results(path)
        with open(os.path.join(d, "profile", "resnet_train_gpu",
                               "kernel_summary.csv")) as f:
            summary = list(csv.DictReader(f))
    over = [(r["bench_id"], r["value"]) for r in rows
            if r["unit"] == "GFLOPS"
            and r["value"] >= peak_gflops(str(r["extra"].get("dtype", "")))]
    check(not over, f"rows at or above the card's peak: {over}")
    by_id = {(r["bench_id"], r["metric"]): r for r in rows}
    agree = by_id[("gemm_8192x8192x8192_bfloat16_default_agreement",
                   "ratio")]["value"]
    check(0.9 <= agree <= 1.1,
          f"timing_check at 8192^3 bf16: graph replay / batch = {agree}")
    loss = by_id[("resnet50_cifar_b256", "step_time_ms")]["extra"][
        "final_loss"]
    check(np.isfinite(loss), f"resnet_train loss {loss}")

    def brief(r):
        e = r["extra"]
        return {"id": r["bench_id"], "value": r["value"], "unit": r["unit"],
                **{k: e[k] for k in ("mean_ms", "min_ms", "mfu", "mbu",
                                     "chain_overhead_us",
                                     "gflops_nooverhead", "final_loss")
                   if k in e}}
    for config in ("gemm", "timing_check", "conv_sweep", "resnet_train"):
        out[config] = [brief(r) for r in rows if r["config"] == config]

    # where a ResNet-50 training step spends the card's time
    check(summary and summary[0]["plane"].startswith("/device:GPU"),
          "the ResNet trace holds no device events")
    wall_ms = by_id[("resnet50_cifar_b256", "step_time_ms")]["value"]
    device_ms = sum(float(r["total_us"]) for r in summary) \
        / RESNET_TRACED / 1e3
    out["resnet_step_profile"] = {
        "batch": 256, "wall_ms": wall_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "kernels_per_step": sum(int(r["calls"]) for r in summary)
        / RESNET_TRACED,
        "top": [[r["name"][:80], int(r["calls"]) // RESNET_TRACED,
                 float(r["total_us"]) / RESNET_TRACED / 1e3]
                for r in summary[:10]]}

    # the space-to-depth stem against the 7x7 stride-2 conv, fp32
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 224, 224, 3, generator=gen).to(dev)
    w = torch.randn(7, 7, 3, 64, generator=gen).to(dev)
    xs, ws = conv.space_to_depth_inputs(x), \
        conv.space_to_depth_conv1_weights(w)
    ref = conv.conv2d(x, w, 2, "float32")
    scale = float(ref.abs().max())
    s2d = float((conv.conv2d(xs, ws, 1, "float32") - ref).abs().max())
    tf32 = float((conv.conv2d(xs, ws, 1, "tensorfloat32") - ref).abs().max())
    check(s2d <= S2D_REL * scale, f"conv1_s2d vs conv1: {s2d} of {scale}")
    check(tf32 > S2D_REL * scale, f"TF32 s2d within the fp32 limit: {tf32}")
    out["conv1_s2d"] = {"max_abs_err": s2d, "largest": scale,
                        "tf32_yardstick": tf32, "limit_rel": S2D_REL}

    # one ResNet training step on the card and on the CPU
    init = {k: v.clone() for k, v in resnet18_ish(
        num_classes=10, dtype=torch.float32, device="cpu",
        seed=seed).state_dict().items()}
    batch = next(cifar_like_batches(CONFIG_CHECK_BATCH, seed=seed, steps=1))
    want = resnet_step("cpu", init, batch)
    got = resnet_step(dev, init, batch)
    wrong = resnet_step(dev, init, batch, wrong=True)
    out["resnet_cuda_vs_cpu"] = {"batch": CONFIG_CHECK_BATCH,
                                 "gaps": resnet_gaps(got, want),
                                 "wrong_weight_gaps": resnet_gaps(wrong,
                                                                  want),
                                 "loss": [got[1], want[1]],
                                 "limit_rel": RESNET_REL,
                                 "update_limit_rel": RESNET_UPDATE_REL}
    fwd, bwd = resnet_held(out["resnet_cuda_vs_cpu"]["gaps"])
    check(fwd and bwd, f"ResNet step card vs CPU: {out}")
    fwd, bwd = resnet_held(out["resnet_cuda_vs_cpu"]["wrong_weight_gaps"])
    check(not fwd and not bwd,
          f"wrong-weight ResNet within a limit: {out}")
    emit({"phase": "configs", **out})


def phase_kernel_matrix(dev, seed):
    """The parity harness's matrices on the card, its yardstick, the
    kernel_matrix config and the sparse bench (see the module
    docstring)."""
    import tempfile

    import numpy as np
    import torch
    from tosem_tpu_torch import cli
    from tosem_tpu_torch.ops import parity
    from tosem_tpu_torch.ops.bench_sparse import run_sparse_benchmarks
    from tosem_tpu_torch.utils.results import read_results
    out = {"gpu": gpu_line()}
    t = time.perf_counter()
    recs = parity.run_matrix(platform="cuda")
    n_cells = sum(len(parity.scenarios(f)) for f in parity.FAMILIES)
    check(len(recs) == n_cells and all(
        r["pair"] == ("cuda", "torch") for r in recs),
        f"{len(recs)} parity cells, not {n_cells} cuda/torch pairs")
    worst = {}
    for r in recs:
        key = f"{r['family']}:{r['dtype']}"
        worst[key] = max(worst.get(key, 0.0), r["max_abs_diff"])
    out["matrix"] = {"cells": len(recs), "worst": worst,
                     "tolerances": parity.TOLERANCES,
                     "s": time.perf_counter() - t}
    # the yardstick: B1 on the local-mask cell with its mask dropped
    sc = next(s for s in parity.scenarios("flash") if s.name == "local_mask")
    args, kwargs = parity.build_case(sc, device=dev)
    with torch.no_grad():
        bad = parity._np(parity.run_arm(
            "flash", "cuda", args,
            {k: v for k, v in kwargs.items() if k != "mask"}))
    want = parity._run_cell("flash", "torch", sc, 0)
    broke = False
    try:
        parity._assert_close(bad, want, parity.TOLERANCES["flash"][sc.dtype],
                             "flash", sc, "cuda without its mask vs torch",
                             *parity.build_case(sc))
    except AssertionError:
        broke = True
    check(broke, "B1 with its mask dropped passed the parity check")
    out["dropped_mask_gap"] = float(np.abs(bad - want).max())
    with tempfile.TemporaryDirectory(prefix="torch_kernel_matrix_") as d:
        path = os.path.join(d, "kernel_matrix.csv")
        t = time.perf_counter()
        check(cli.main(["--config=kernel_matrix",
                        f"--results_csv={path}"]) == 0,
              "the kernel_matrix config failed")
        rows = read_results(path)
        out["kernel_matrix_s"] = time.perf_counter() - t
    ids = {r["bench_id"]: r for r in rows}
    for fam in parity.FAMILIES:
        card = ids.get(f"kernels_{fam}_cuda")
        host = ids.get(f"kernels_{fam}_torch")
        check(card is not None and card["extra"]["timing"] == "graph_replay"
              and card["extra"]["on_chip"] and card["value"] > 0,
              f"kernel_matrix {fam}: cuda row {card}")
        check(host is not None and host["extra"]["timing"] == "host",
              f"kernel_matrix {fam}: torch row {host}")
    out["kernel_matrix"] = [{"id": r["bench_id"], "it_s": r["value"],
                             "rounds": r["extra"].get("rounds"),
                             "timing": r["extra"]["timing"]} for r in rows]
    t = time.perf_counter()
    sparse = run_sparse_benchmarks(trials=2, min_s=0.2, quiet=True,
                                   device=dev)
    out["sparse_s"] = time.perf_counter() - t
    check(len(sparse) == 3 and all(np.isfinite(r.value) and r.value > 0
                                   for r in sparse),
          f"sparse bench rows {[(r.bench_id, r.value) for r in sparse]}")
    out["sparse"] = [{"id": r.bench_id, "value": r.value, "unit": r.unit,
                      "rounds": r.extra.get("rounds"),
                      "executed_block_fraction":
                          r.extra.get("executed_block_fraction")}
                     for r in sparse]
    emit({"phase": "kernel_matrix", **out})


MOE_EXPERTS = 4        # bert_tiny_moe's expert count; moe_every 2, k 2
MOE_STEPS = 10         # timed MoE-BERT MLM steps
MOE_TRACED = 2         # of them traced for the device breakdown
MOE_AUX_WEIGHT = 0.01  # the aux loss' weight in the task loss
MOE_EP_TOKENS = 2048   # tokens through the ep-sharded layer
MOE_TOL = 1e-3         # card vs CPU fp32, of the largest value
EP_TOL = 2e-5          # ep vs unsharded y (rtol and atol, the reference's)
EP_GRAD_TOL = 1e-3     # ep vs unsharded fp32 gradients, per tensor


def moe_mlm_loss(model, batch, generator=None, *, attn_fn=None):
    """``mlm_loss`` plus ``MOE_AUX_WEIGHT`` times the routed layers' aux
    loss (``tests/test_moe_bert.py``'s objective); the aux rides the
    metrics."""
    from tosem_tpu_torch.train.trainer import cross_entropy_loss
    enc, state = model.apply(batch["ids"], mask=batch.get("mask"),
                             train=True, attn_fn=attn_fn,
                             generator=generator, return_state=True)
    task = cross_entropy_loss(model.mlm_logits(enc), batch["labels"],
                              batch.get("masked"))
    aux = state["moe_aux"]
    return task + MOE_AUX_WEIGHT * aux, {"moe_aux": aux.detach(),
                                         "task": task.detach()}


def moe_dropped(model, ids):
    """(token, choice) rows each routed layer drops for capacity on
    ``ids`` (eval, no dropout): its MoE inputs caught by a forward
    pre-hook and routed again."""
    import torch
    from tosem_tpu_torch.nn.moe import MoELayer, route
    out, hooks = [], []

    def pre(mod, args):
        out.append(int(route(args[0], mod.gate, mod.k,
                             mod.capacity_factor)[3]))
    for m in model.modules():
        if isinstance(m, MoELayer):
            hooks.append(m.register_forward_pre_hook(pre))
    try:
        with torch.no_grad():
            model.apply(ids)
    finally:
        for h in hooks:
            h.remove()
    return out


def moe_parity(dev, seed):
    """``bert_tiny_moe(4)`` in fp32 (TF32 off, dense attention) on the
    card and on the CPU from one set of weights: encodings, aux and MLM
    logits, each within MOE_TOL of the largest value; the CPU model with
    layer 1's experts' ``w2`` scaled by 1.1 must break the check."""
    import dataclasses

    import numpy as np
    import torch
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.ops.common import precision
    cfg = dataclasses.replace(BertConfig.tiny(), moe_experts=MOE_EXPERTS,
                              dtype="float32")
    cpu = Bert(cfg, device="cpu", seed=seed)
    card = Bert(cfg, device=dev, seed=seed)
    wrong = Bert(cfg, device="cpu", seed=seed)
    with torch.no_grad():
        wrong.layers[1].moe.w2.mul_(1.1)
    ids = torch.as_tensor(np.random.default_rng(seed + 3).integers(
        0, cfg.vocab_size, (4, 64)))

    def run(m):
        with torch.no_grad(), precision("float32"):
            h, st = m.apply(ids.to(m.device), return_state=True)
            return [t.float().cpu() for t in (h, st["moe_aux"],
                                              m.mlm_logits(h))]

    want, got, bad = run(cpu), run(card), run(wrong)

    def gaps(a):
        return [float((x - w).abs().max() / w.abs().max())
                for x, w in zip(a, want)]
    g, y = gaps(got), gaps(bad)
    names = ("encodings", "aux", "mlm_logits")
    check(all(v <= MOE_TOL for v in g),
          f"MoE-BERT card vs CPU: {dict(zip(names, g))} > {MOE_TOL}")
    check(max(y) > MOE_TOL, f"a wrong MoE expert passed: {y}")
    return {"config": "bert_tiny_moe(4) fp32", "tol": MOE_TOL,
            "rel_gaps": dict(zip(names, g)),
            "wrong_expert_rel_gaps": dict(zip(names, y))}


def moe_ep(dev, seed):
    """The MoE layer at BERT-base widths (768 -> 3072, 4 experts, k 2,
    capacity 1.25) in fp32 over ep = 4 positions on the card
    (``ExpertParallelMoE``) against the unsharded layer: y within EP_TOL,
    aux within rel 1e-5, the input's and every parameter's gradient
    within EP_GRAD_TOL of its largest value; the ms of a forward and
    backward of each."""
    import numpy as np
    import torch
    from tosem_tpu_torch.nn.moe import EXPERT_PARAMS, ExpertParallelMoE, \
        MoELayer
    from tosem_tpu_torch.parallel.mesh import default_mesh
    layer = MoELayer(768, MOE_EXPERTS, hidden=3072, k=2,
                     capacity_factor=1.25,
                     generator=torch.Generator().manual_seed(seed)).to(dev)
    mesh = default_mesh("ep", [torch.device(dev, 0)] * 4)
    ep = ExpertParallelMoE(layer, mesh)
    rng = np.random.default_rng(seed + 4)
    x = torch.as_tensor(rng.normal(size=(MOE_EP_TOKENS, 768)),
                        dtype=torch.float32, device=dev).requires_grad_(True)
    yt = torch.as_tensor(0.3 * rng.normal(size=(MOE_EP_TOKENS, 768)),
                         dtype=torch.float32, device=dev)

    def fwd_bwd(run, params):
        y, aux = run(x)
        loss = torch.mean((y - yt) ** 2) + MOE_AUX_WEIGHT * aux
        return y.detach(), aux.detach(), torch.autograd.grad(
            loss, [x] + params)
    base_params = [layer.gate] + [getattr(layer, n) for n in EXPERT_PARAMS]
    ep_params = [ep.gate] + list(ep._pieces)
    y0, a0, g0 = fwd_bwd(layer, base_params)
    y1, a1, g1 = fwd_bwd(ep, ep_params)
    n = mesh.size
    g1 = list(g1[:2]) + [torch.cat(g1[2 + i * n:2 + (i + 1) * n])
                         for i in range(len(EXPERT_PARAMS))]
    names = ("x", "gate") + EXPERT_PARAMS
    y_gap = float(((y1 - y0).abs() - EP_TOL * y0.abs()).max())
    grad_gaps = {nm: float((a - b).abs().max() / b.abs().max()
                           .clamp_min(1e-30))
                 for nm, a, b in zip(names, g1, g0)}
    check(y_gap <= EP_TOL, f"ep y off the unsharded layer by {y_gap}")
    check(abs(float(a1) - float(a0)) <= 1e-5 * abs(float(a0)),
          f"ep aux {float(a1)} vs {float(a0)}")
    check(all(v <= EP_GRAD_TOL for v in grad_gaps.values()),
          f"ep gradients: {grad_gaps}")
    check(all(p.shape[0] == MOE_EXPERTS // n
              for p in ep.blocks["w1"].pieces), "ep blocks not cut")

    def ms(run, params, reps=3):
        fwd_bwd(run, params)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fwd_bwd(run, params)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3
    return {"tokens": MOE_EP_TOKENS, "positions": n,
            "y_max_excess_over_tol": y_gap, "aux": [float(a0), float(a1)],
            "grad_rel_gaps": grad_gaps,
            "fwd_bwd_ms": {"unsharded": ms(layer, base_params),
                           "ep4_one_card": ms(ep, ep_params)}}


def phase_moe(dev, seed, steps=MOE_STEPS):
    """MoE-BERT at BERT-base widths on the card: ``BertConfig.base()``
    with ``moe_experts = 4`` (every second layer routed, k 2, capacity
    1.25; bf16, dropout 0.1), weights from seed 0. An 8 x 512 encode
    through ``encode_fn(attn_fn=flash_attn_fn())`` (B1 12 launches),
    then ``steps`` MLM train steps (adamw(1e-4), loss + 0.01 aux; B1-B3
    12 launches a step each), whose loss must be finite and fall; two
    more steps traced for the device breakdown; the capacity drops
    before and after training. Then :func:`moe_parity` and
    :func:`moe_ep`."""
    import dataclasses
    import functools

    import numpy as np
    import torch
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.train import (adamw, create_train_state,
                                       make_train_step)
    from tosem_tpu_torch.train.trainer import step_generator
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(BertConfig.base(), moe_experts=MOE_EXPERTS)
    model = Bert(cfg, device=dev, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    B, T = 8, 512
    rng = np.random.default_rng(seed + 1)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                          device=dev)
    masked = torch.as_tensor(rng.random((B, T)) < 0.15, device=dev)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    enc_fn = model.encode_fn(attn_fn=flash_attn_fn())
    enc_fn(ids, mask)
    torch.cuda.synchronize()
    registry.reset_launch_counts()
    t = time.perf_counter()
    enc = enc_fn(ids, mask)
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t) * 1e3
    enc_counts = dict(registry.LAUNCH_COUNTS)
    check(enc_counts["flash_fwd"] == cfg.layers,
          f"MoE encode: flash_fwd {enc_counts['flash_fwd']} launches, not "
          f"{cfg.layers}")
    check(bool(torch.isfinite(enc.float()).all()), "MoE encode not finite")
    dropped_before = moe_dropped(model, ids)

    st = create_train_state(model, adamw(1e-4))
    step = make_train_step(model, st.optimizer, functools.partial(
        moe_mlm_loss, attn_fn=flash_attn_fn()))
    batch = {"ids": ids, "labels": ids, "masked": masked}
    torch.cuda.synchronize()
    registry.reset_launch_counts()
    mets = []
    t = time.perf_counter()
    for i in range(steps):
        st, met = step(st, batch, step_generator(seed, i, dev))
        mets.append(met)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / steps * 1e3
    counts = dict(registry.LAUNCH_COUNTS)
    losses = [float(m["loss"]) for m in mets]
    auxes = [float(m["moe_aux"]) for m in mets]
    check(all(np.isfinite(losses)), f"MoE train losses {losses}")
    check(losses[-1] < losses[0], f"MoE train loss did not fall: {losses}")
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        check(counts[name] == cfg.layers * steps,
              f"MoE train: {name} {counts[name]} launches in {steps} "
              f"steps, not {cfg.layers} a step")
    mem = torch.cuda.max_memory_allocated() / 2**30

    def traced_steps():
        nonlocal st
        for i in range(steps, steps + MOE_TRACED):
            st, _ = step(st, batch, step_generator(seed, i, dev))
    wall = _timed(traced_steps)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced = _timed(traced_steps)
    breakdown = _device_breakdown(prof, wall, traced, MOE_TRACED)
    registry.reset_launch_counts()
    dropped_after = moe_dropped(model, ids)
    capacity = model.layers[1].moe.capacity(B * T)
    del st, step, model, enc, enc_fn
    torch.cuda.empty_cache()
    parity = moe_parity(dev, seed)
    ep = moe_ep(dev, seed)
    emit({"phase": "moe", "gpu": gpu_line(),
          "config": "BERT-base bf16, moe_experts 4, moe_every 2, k 2, "
                    "capacity 1.25, dropout 0.1",
          "params": n_params, "batch": [B, T], "capacity": capacity,
          "encode_ms": enc_ms, "encode_launches": enc_counts,
          "steps": steps, "losses": losses, "aux": auxes,
          "step_ms": step_ms, "tokens_per_s": B * T / step_ms * 1e3,
          "max_memory_gib": mem,
          "dropped_per_routed_layer": {"before": dropped_before,
                                       "after": dropped_after,
                                       "of": 2 * B * T},
          "launches_train": counts, "device_breakdown": breakdown,
          "parity": parity, "ep": ep})
    return {k: enc_counts[k] + counts[k] for k in KERNELS}


SPEECH_UTTS = 8                # utterances a speech leg serves
SPEECH_FRAMES = (150, 500)     # their frame counts, drawn from seed
SPEECH_BUCKETS = [256, 512]    # SpeechBatchBackend's padding buckets
SPEECH_CHUNK = 8               # frames a SpeechDecodeBackend step
SPEECH_ROW_TOL = 1e-4          # logits rows, served vs full pass (fp32)
MFCC_TOL = 1e-3                # card vs CPU MFCC, of the largest value
CTC_TOL = 1e-4                 # card vs CPU CTC loss and gradient
SPEECH_TRAIN_STEPS = 3         # Adam steps of full-width CTC training


def speech_replica_class():
    """``SpeechDecodeBackend`` as the speech phase deploys it: its
    results carry the logits rows, and each step's time is kept (read
    through ``stats``). Defined in a function so cloudpickle ships it by
    value to the replica."""
    from tosem_tpu_torch.serve.speech import SpeechDecodeBackend

    class ServedSpeech(SpeechDecodeBackend):
        def step_batch(self, seq_ids, step_idxs):
            import torch
            t = time.perf_counter()
            try:
                return super().step_batch(seq_ids, step_idxs)
            finally:
                if self.device.type == "cuda":
                    torch.cuda.synchronize()
                self.step_ms.append((time.perf_counter() - t) * 1e3)

        def warmup(self, shapes):
            out = super().warmup(shapes)
            self.step_ms = []
            self.admit("warm", {"frames": [[0.0] * self.cfg.n_input]})
            while not self.step_batch(["warm"], [self._seqs["warm"]
                                                 .next_step])[0]["done"]:
                pass
            self.release("warm")
            self.step_ms = []
            return out

        def _result_locked(self, seq):
            out = super()._result_locked(seq)
            out["rows"] = self._rows_locked(seq)
            return out

        def stats(self):
            out = replica_stats(super().stats())
            out["step_ms"] = list(getattr(self, "step_ms", []))
            return out

    return ServedSpeech


def speech_utterances(seed, n_input):
    import numpy as np
    rng = np.random.default_rng(seed + 5)
    lens = rng.integers(SPEECH_FRAMES[0], SPEECH_FRAMES[1] + 1, SPEECH_UTTS)
    return [rng.normal(size=(int(n), n_input)).astype(np.float32)
            for n in lens]


def speech_mfcc(dev, wavs):
    """MFCC of each WAV on the card and on the CPU (fp32)."""
    import numpy as np
    import torch
    from tosem_tpu_torch.data.audio import mfcc
    gaps, frames = [], 0
    for a in wavs:
        x = torch.from_numpy(np.asarray(a, np.float32))
        want = mfcc(x)
        got = mfcc(x.to(dev)).cpu()
        check(got.shape == want.shape, f"MFCC shape {got.shape}")
        gaps.append(float((got - want).abs().max() / want.abs().max()))
        frames += want.shape[0]
    check(max(gaps) <= MFCC_TOL, f"MFCC card vs CPU: {max(gaps)}")
    return {"wavs": len(wavs), "frames": frames, "tol": MFCC_TOL,
            "max_rel_gap": max(gaps)}


def speech_batch(dev, seed, utts, full):
    """``SpeechBatchBackend`` (full width, max_batch 8): each bucket's
    utterances in one batch against each alone at the same bucket, by
    text and by logits rows, and each row against the utterance's own
    full pass."""
    import numpy as np
    from tosem_tpu_torch.data.feeding import bucket_for
    from tosem_tpu_torch.serve.speech import SpeechBatchBackend
    b = SpeechBatchBackend(cfg_name="full", seed=seed, max_batch=8,
                           device=dev)
    by_bucket = {}
    for i, u in enumerate(utts):
        by_bucket.setdefault(bucket_for(len(u), SPEECH_BUCKETS), []).append(i)
    seq_gap = full_gap = 0.0
    t_batched = []
    for bucket, idx in sorted(by_bucket.items()):
        reqs = [{"frames": utts[i]} for i in idx]
        t = time.perf_counter()
        texts = b.call_batch(reqs, pad_to=bucket)
        t_batched.append((time.perf_counter() - t) * 1e3)
        logits, lengths = b.logits_batch(reqs, pad_to=bucket)
        for j, i in enumerate(idx):
            alone, _ = b.logits_batch([reqs[j]], pad_to=bucket)
            n = int(lengths[j])
            check(texts[j]["text"] == b.call_batch([reqs[j]],
                                                   pad_to=bucket)[0]["text"],
                  f"utterance {i}: batched text != sequential")
            seq_gap = max(seq_gap, float(np.abs(logits[j, :n]
                                                - alone[0, :n]).max()))
            full_gap = max(full_gap, float(np.abs(logits[j, :n]
                                                  - full[i]).max()))
    check(seq_gap <= SPEECH_ROW_TOL, f"batched vs sequential rows {seq_gap}")
    check(full_gap <= SPEECH_ROW_TOL, f"batched vs full-pass rows {full_gap}")
    return {"buckets": {str(k): len(v) for k, v in by_bucket.items()},
            "batched_vs_sequential_max_abs": seq_gap,
            "batched_vs_full_pass_max_abs": full_gap,
            "batch_ms": t_batched}


def speech_decode_direct(dev, seed, utts, full):
    """The decode backend in this process, 8 streams packed: ms per
    scheduler step on the host clock, then the same steps traced for the
    device time and busy share."""
    import numpy as np
    import torch
    from tosem_tpu_torch.serve.speech import SpeechDecodeBackend
    b = SpeechDecodeBackend(cfg_name="full", seed=seed, max_batch=8,
                            chunk_frames=SPEECH_CHUNK, max_frames=512,
                            device=dev)

    def drive(tag):
        ids = [f"{tag}{i}" for i in range(len(utts))]
        for sid, u in zip(ids, utts):
            b.admit(sid, {"frames": u})
        live, step = list(ids), 0
        while live:
            outs = b.step_batch(live, [step] * len(live))
            live = [s for s, o in zip(live, outs) if not o["done"]]
            step += 1
        rows = [b.logits_rows(s) for s in ids]
        for s in ids:
            b.release(s)
        return step, rows
    drive("w")
    torch.cuda.synchronize()
    t = time.perf_counter()
    n_steps, rows = drive("a")
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced = _timed(lambda: drive("p"))
    gap = max(float(np.abs(r - f).max()) for r, f in zip(rows, full))
    check(gap <= SPEECH_ROW_TOL, f"direct streamed rows vs full pass {gap}")
    return {"steps": n_steps, "ms_per_step": wall / n_steps,
            "rows_vs_full_pass_max_abs": gap,
            "device_breakdown": _device_breakdown(prof, wall, traced,
                                                  n_steps)}


def speech_decode_served(dev, seed, utts, full, texts):
    """``SpeechDecodeBackend`` (full width, max_batch 8, chunk 8) in a
    replica process behind ``DecodeQueue``: the 8 utterances at once,
    each answer's text the full pass's and its rows within
    SPEECH_ROW_TOL."""
    import numpy as np
    import tosem_tpu_torch.runtime as rt
    from tosem_tpu_torch.serve import DecodePolicy, Serve
    served = speech_replica_class()
    serve = Serve()
    try:
        t = time.perf_counter()
        dep = serve.deploy("speech", served, init_kwargs=dict(
            cfg_name="full", seed=seed, max_batch=8,
            chunk_frames=SPEECH_CHUNK, max_frames=512, device=dev),
            decode_policy=DecodePolicy(max_active=8), warmup_shapes=[1])
        deploy_s = time.perf_counter() - t
        h = serve.get_handle("speech")
        t = time.perf_counter()
        futs = [h.remote({"frames": u.tolist()}) for u in utts]
        got = [f.result(timeout=300.0) for f in futs]
        wall = time.perf_counter() - t
        rep = rt.get(dep._replicas[0].stats.remote(), timeout=60)
        dstats = dep.stats()
    finally:
        for name in list(serve.list_deployments()):
            serve.delete(name)
        rt.shutdown()
    gap = 0.0
    for i, (g, f) in enumerate(zip(got, full)):
        check(g["text"] == texts[i], f"served stream {i}: {g['text']!r} "
              f"!= full pass {texts[i]!r}")
        gap = max(gap, float(np.abs(np.asarray(g["rows"]) - f).max()))
    check(gap <= SPEECH_ROW_TOL, f"served rows vs full pass {gap}")
    steps = rep["step_ms"]
    return {"deploy_s": deploy_s, "wall_s": wall,
            "scheduler_steps": dstats["decode_steps"],
            "ms_per_scheduler_step": wall * 1e3 / dstats["decode_steps"],
            "replica_step_ms_median": float(np.median(steps)),
            "sequences_ok": dstats["sequences_ok"],
            "rows_vs_full_pass_max_abs": gap}


def speech_c_api(dev, seed, utts, full, texts):
    """One stream through the built ``speech_api`` library, fed uneven
    chunks, against the full pass's greedy text."""
    from tosem_tpu_torch.serve.speech import (SERVE_ALPHABET,
                                              CStreamingModel,
                                              build_speech_model)
    model = build_speech_model("full", seed=seed, device=dev)
    cm = CStreamingModel(model, SERVE_ALPHABET[:model.cfg.n_classes - 1],
                         chunk_frames=16)
    try:
        u = utts[0]
        s = cm.create_stream()
        t = time.perf_counter()
        for a, b in ((0, 7), (7, 30), (30, 31), (31, 100), (100, len(u))):
            cm.feed(s, u[a:b])
        mid = cm.intermediate(s)
        text = cm.finish(s)
        ms = (time.perf_counter() - t) * 1e3
    finally:
        cm.close()
    check(text == texts[0], f"C API stream {text!r} != full pass "
          f"{texts[0]!r}")
    return {"frames": len(u), "text_chars": len(text), "ms": ms,
            "intermediate_is_prefix": texts[0].startswith(mid)}


def speech_ctc(dev, seed):
    """CTC loss and its gradient at [8, 500, 29] on the card against the
    CPU (fp32), timed beside ``F.ctc_loss`` (a library yardstick, not on
    the path); the beam decoder with a scorer from ``build_scorer``."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from tosem_tpu_torch.data.audio import ALPHABET, labels_to_text
    from tosem_tpu_torch.data.scorer import build_scorer
    from tosem_tpu_torch.ops.ctc import Scorer, beam_search_decode, ctc_loss
    rng = np.random.default_rng(seed + 6)
    B, T, V, L = 8, 500, 29, 60
    logits = torch.as_tensor(3 * rng.normal(size=(B, T, V)),
                             dtype=torch.float32)
    labels = torch.as_tensor(rng.integers(0, V - 1, (B, L)))
    il = torch.as_tensor(rng.integers(300, T + 1, B))
    ll = torch.as_tensor(rng.integers(10, L + 1, B))

    def run(where):
        x = logits.to(where).detach().requires_grad_(True)
        loss = ctc_loss(x, labels.to(where), il.to(where), ll.to(where),
                        blank=V - 1)
        loss.sum().backward()
        return loss.detach().cpu(), x.grad.cpu()
    want, g_want = run("cpu")
    got, g_got = run(dev)
    loss_gap = float(((got - want).abs() / want.abs()).max())
    grad_gap = float((g_got - g_want).abs().max() / g_want.abs().max())
    check(loss_gap <= CTC_TOL and grad_gap <= CTC_TOL,
          f"CTC card vs CPU: loss {loss_gap}, gradient {grad_gap}")

    def port_fb():
        x = logits.to(dev).detach().requires_grad_(True)
        ctc_loss(x, labels.to(dev), il.to(dev), ll.to(dev),
                 blank=V - 1).sum().backward()
    xs = logits.to(dev).log_softmax(-1).transpose(0, 1).contiguous()

    def lib_fb():
        x = xs.detach().requires_grad_(True)
        F.ctc_loss(x, labels.to(dev), il.to(dev), ll.to(dev), blank=V - 1,
                   reduction="sum").backward()
    port_ms = cuda_ms(port_fb, iters=3, warmup=1)
    lib_ms = cuda_ms(lib_fb, iters=3, warmup=1)
    lib_loss = F.ctc_loss(xs.cpu(), labels, il, ll, blank=V - 1,
                          reduction="none")
    import tempfile
    with tempfile.TemporaryDirectory(prefix="torch_scorer_") as d:
        path = os.path.join(d, "s.scorer")
        texts = ["".join(rng.choice(list(ALPHABET[:26]), 4)) for _ in
                 range(30)]
        build_scorer([" ".join(texts[i:i + 3]) for i in range(0, 30, 3)],
                     path, order=2)
        sc = Scorer(path, alpha=1.0, beta=0.3, space_index=ALPHABET.index(" "))
        lp = torch.log_softmax(got.new_tensor(3 * rng.normal(size=(T, V))),
                               -1).numpy()
        t = time.perf_counter()
        lab1, s1 = beam_search_decode(lp, blank=V - 1, beam_width=16,
                                      scorer=sc)
        beam_ms = (time.perf_counter() - t) * 1e3
        lab2, s2 = beam_search_decode(lp, blank=V - 1, beam_width=16,
                                      scorer=sc)
        sc.close()
    check(lab1 == lab2 and s1 == s2, "beam decode with a scorer is not "
          "deterministic")
    return {"shape": [B, T, V], "labels": L, "tol": CTC_TOL,
            "loss_max_rel_gap": loss_gap, "grad_rel_gap": grad_gap,
            "port_fwd_bwd_ms": port_ms,
            "library_F_ctc_loss_fwd_bwd_ms": lib_ms,
            "library_vs_port_loss_max_abs": float(
                (lib_loss - want).abs().max()),
            "beam_lm_ms": beam_ms, "beam_lm_chars": len(labels_to_text(lab1))}


def speech_train_full(dev, seed, utts):
    """SPEECH_TRAIN_STEPS Adam steps of CTC training at full width on a
    batch of 8 of the phase's utterances (random labels of 20-60
    symbols), the loss finite, ms a step."""
    import functools

    import numpy as np
    import torch
    from tosem_tpu_torch.models.speech import (SpeechConfig, SpeechModel,
                                               pad_feats_batch)
    from tosem_tpu_torch.ops.ctc import ctc_loss_mean
    from tosem_tpu_torch.train.trainer import (create_train_state,
                                               make_train_step)
    cfg = SpeechConfig()
    model = SpeechModel(cfg, device=dev, seed=seed)
    feats, lengths = pad_feats_batch(utts, max(len(u) for u in utts))
    rng = np.random.default_rng(seed + 7)
    ll = rng.integers(20, 61, len(utts))
    labels = rng.integers(0, cfg.vocab_size, (len(utts), 60))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             (("feats", feats), ("il", lengths), ("labels", labels),
              ("ll", ll))}

    def loss_fn(m, b, generator=None):
        logits, _ = m(b["feats"], train=True, generator=generator)
        return ctc_loss_mean(logits, b["labels"], b["il"], b["ll"],
                             blank=cfg.blank), {}
    torch.cuda.reset_peak_memory_stats()
    st = create_train_state(model, functools.partial(torch.optim.Adam,
                                                     lr=3e-3))
    step = make_train_step(model, st.optimizer, loss_fn)
    gen = torch.Generator(device=dev).manual_seed(seed)
    losses, ms = [], []
    for _ in range(SPEECH_TRAIN_STEPS):
        t = time.perf_counter()
        st, met = step(st, batch, gen)
        losses.append(float(met["loss"]))
        ms.append((time.perf_counter() - t) * 1e3)
    check(all(np.isfinite(losses)), f"full-width CTC losses {losses}")
    return {"batch": [len(utts), int(feats.shape[1])], "losses": losses,
            "step_ms": ms,
            "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30}


def speech_cli(dev):
    """``cli --config=speech_train --steps=3`` on the card: the four rows,
    device gpu, the loss below the run's first."""
    import tempfile

    from tosem_tpu_torch import cli
    from tosem_tpu_torch.utils.results import read_results
    with tempfile.TemporaryDirectory(prefix="torch_speech_train_") as d:
        path = os.path.join(d, "speech.csv")
        t = time.perf_counter()
        check(cli.main([f"--device={dev}", "--config=speech_train",
                        "--steps=3", f"--results_csv={path}"]) == 0,
              "the speech_train config failed")
        secs = time.perf_counter() - t
        rows = {r["bench_id"]: r for r in read_results(path)}
    want = {"speech_ctc_loss", "speech_wer_greedy", "speech_wer_beam",
            "speech_wer_beam_lm"}
    check(set(rows) == want, f"speech_train rows {sorted(rows)}")
    check(all(r["device"] == "gpu" for r in rows.values()),
          "speech_train rows not on gpu")
    loss = rows["speech_ctc_loss"]
    check(loss["value"] < loss["extra"]["first_loss"],
          f"speech_train loss {loss['value']} not below its first "
          f"{loss['extra']['first_loss']}")
    return {"seconds": secs,
            **{k: r["value"] for k, r in sorted(rows.items())},
            "first_loss": loss["extra"]["first_loss"],
            "epochs": loss["extra"]["epochs"],
            "train_steps": loss["extra"]["steps"]}


def phase_speech(dev, seed):
    """The DeepSpeech family on the card at ``SpeechConfig()``'s full
    width (26 MFCC, context 9, 2048 hidden, 2048 cells, 28 symbols +
    blank), weights from seed 0: MFCC of the synthetic corpus' 16 WAVs,
    the batch backend, the decode backend (in this process, traced, and
    behind ``DecodeQueue`` in a replica), the C streaming API, CTC loss
    and the beam decoder, full-width training, and the CLI's
    ``speech_train``. No kernel of ``csrc/`` is on this path."""
    import tempfile

    import numpy as np
    import torch
    from tosem_tpu_torch.data.feeding import (import_synthetic_corpus,
                                              read_csv_manifest)
    from tosem_tpu_torch.serve.speech import (SERVE_ALPHABET,
                                              build_speech_model,
                                              greedy_ctc_text)
    out = {"phase": "speech", "gpu": gpu_line(),
           "config": "SpeechConfig() full width, fp32"}
    secs = {}

    def leg(name, fn, *a):
        t = time.perf_counter()
        out[name] = fn(*a)
        secs[name] = time.perf_counter() - t

    with tempfile.TemporaryDirectory(prefix="torch_speech_") as d:
        wavs = [s.load_audio() for s in read_csv_manifest(
            import_synthetic_corpus(d, n=16, seed=seed))]
    leg("mfcc", speech_mfcc, dev, wavs)
    model = build_speech_model("full", seed=seed, device=dev)
    utts = speech_utterances(seed, model.cfg.n_input)
    full, texts = [], []
    t = time.perf_counter()
    with torch.no_grad():
        for u in utts:
            f = model(torch.from_numpy(u)[None].to(dev))[0][0].cpu().numpy()
            full.append(f)
            texts.append(greedy_ctc_text(
                f, SERVE_ALPHABET[:model.cfg.n_classes - 1],
                model.cfg.blank))
    secs["full_passes"] = time.perf_counter() - t
    out["utterance_frames"] = [len(u) for u in utts]
    del model
    leg("batch", speech_batch, dev, seed, utts, full)
    leg("decode_direct", speech_decode_direct, dev, seed, utts, full)
    leg("decode_served", speech_decode_served, dev, seed, utts, full, texts)
    leg("c_api", speech_c_api, dev, seed, utts, full, texts)
    leg("ctc", speech_ctc, dev, seed)
    leg("train_full_width", speech_train_full, dev, seed, utts)
    leg("cli_speech_train", speech_cli, dev)
    torch.cuda.empty_cache()
    out["seconds"] = secs
    out["texts_nonempty"] = int(sum(bool(t) for t in texts))
    emit(out)
    check(np.isfinite(out["train_full_width"]["losses"]).all(),
          "speech phase")


DET_BATCH = 8            # (a) EfficientDet-D0's forward and training batch
DET_STEPS = 5            # (a) its Adam steps (2e-3)
DET_CHECK_BATCH = 2      # (b) the card-vs-CPU D0 step's batch
# (b) card vs CPU, fp32 with TF32 off: eval logits and boxes, the loss and
# the BatchNorm moving stats (each kind over its largest stat) within this
# share of the largest value. The tiny model's fp32 forward reads 1.5e-6
# and 3.7e-6 against the JAX package's on the CPU (tests/
# test_torch_efficientdet.py); D0 is deeper, 16 MBConv blocks and 3 BiFPN
# layers
DET_REL = 1e-3
# (b) each parameter's SGD update (its gradient) card vs CPU in relative
# L2, as RESNET_UPDATE_REL; a gradient that vanishes in exact arithmetic
# (a bias in front of a training-mode BatchNorm, a head BatchNorm with no
# positive anchor: below VANISHING of the largest) is held against the
# largest update's norm
DET_UPDATE_REL = 1e-2
VANISHING = 1e-6
EXPORT_REL = 1e-5        # (c) the reloaded .pt2 vs the eager forward
PP_REL = 1e-5            # (d) PointPillars apply, card vs CPU
NMS_TIE_N = 64           # (d) the tied-score NMS case's boxes
# (d) random boxes at the NMS kernel's chunk boundaries (64 candidates a
# word), and a grid past the one-block sweep's former cap of 49,152
# boxes: the detector's boxes at 245 x 245 pillars of the same 70.4 m
# field
NMS_EDGE_N = (1, 63, 64, 65, 4097)
NMS_BIG_GRID = 245
NMS_IOU_OPS = 14         # fp32 operations of one IoU and its compare


def det_batch(cfg, batch, seed, where):
    """``run_detection_train``'s synthetic recipe at ``cfg``'s size:
    images from numpy seed ``seed``, one box a image at (0.2, 0.25, 0.7,
    0.8) of the side, class 2."""
    import numpy as np
    import torch
    s = cfg.image_size
    imgs = np.random.default_rng(seed).normal(
        size=(batch, s, s, 3)).astype(np.float32)
    boxes = np.tile(np.array([[[0.2 * s, 0.25 * s, 0.7 * s, 0.8 * s]]],
                             np.float32), (batch, 1, 1))
    return {"imgs": torch.from_numpy(imgs).to(where),
            "boxes": torch.from_numpy(boxes).to(where),
            "classes": torch.full((batch, 1), 2, device=where),
            "n_gt": torch.ones(batch, dtype=torch.int32, device=where)}


def det_loss(model, b, anchors):
    from tosem_tpu_torch.models.efficientdet import detection_loss
    cl, bx = model(b["imgs"], train=True)
    return detection_loss(cl, bx, b["boxes"], b["classes"], b["n_gt"],
                          anchors, model.cfg)["loss"]


def det_d0_train(dev, seed):
    """(a) EfficientDet-D0 at full width on the card: a forward at batch
    8, then DET_STEPS Adam steps on the synthetic batch."""
    import numpy as np
    import torch
    from tosem_tpu_torch.models.efficientdet import (efficientdet_d0,
                                                     generate_anchors)
    from tosem_tpu_torch.ops.common import precision
    model = efficientdet_d0(device=dev, seed=seed)
    cfg = model.cfg
    b = det_batch(cfg, DET_BATCH, seed, dev)
    anchors = torch.from_numpy(generate_anchors(cfg)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with precision("float32"):
        fwd_ms = []
        for _ in range(3):
            t = time.perf_counter()
            with torch.no_grad():
                cl, bx = model(b["imgs"])
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t) * 1e3)
        check(tuple(cl.shape) == (DET_BATCH, len(anchors), cfg.num_classes)
              and tuple(bx.shape) == (DET_BATCH, len(anchors), 4)
              and bool(torch.isfinite(cl).all()),
              f"D0 forward: {tuple(cl.shape)} {tuple(bx.shape)}")
        opt = torch.optim.Adam(model.parameters(), lr=2e-3)
        losses, ms = [], []
        for _ in range(DET_STEPS):
            t = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = det_loss(model, b, anchors)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            ms.append((time.perf_counter() - t) * 1e3)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"D0 losses {losses}: not finite or not falling")
    steady = float(np.median(ms[1:]))
    return {"config": "EfficientDetConfig.d0(): 512 px, 90 classes, fp32, "
                      "TF32 off", "params": model.param_count(),
            "anchors": len(anchors), "batch": DET_BATCH,
            "forward_ms": fwd_ms, "step_ms": ms,
            "images_per_s": DET_BATCH / steady * 1e3, "losses": losses,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def det_step(where, init, batch, wrong=False):
    """One SGD step (lr 0.01) of D0 in fp32 (TF32 off) from ``init`` on
    ``batch``: (eval logits and boxes before the step, the step's loss,
    the BatchNorm moving stats after it, each parameter's update; all on
    the CPU). ``wrong`` scales the class head's output conv by 1.1
    first: the yardstick (no BatchNorm follows it)."""
    import torch
    from tosem_tpu_torch.models.efficientdet import (EfficientDet,
                                                     EfficientDetConfig,
                                                     generate_anchors)
    from tosem_tpu_torch.ops.common import precision
    m = EfficientDet(EfficientDetConfig.d0(), device=where)
    m.load_state_dict(init)
    if wrong:
        with torch.no_grad():
            m.class_out.w.mul_(1.1)
    start = {k: v.detach().clone() for k, v in m.named_parameters()}
    b = {k: v.to(where) for k, v in batch.items()}
    anchors = torch.from_numpy(generate_anchors(m.cfg)).to(where)
    opt = torch.optim.SGD(m.parameters(), lr=0.01)
    with precision("float32"):
        with torch.no_grad():
            cl, bx = m(b["imgs"])
            out = torch.cat([cl, bx], -1).cpu()
        opt.zero_grad(set_to_none=True)
        loss = det_loss(m, b, anchors)
        loss.backward()
        opt.step()
    return (out, float(loss),
            {k: v.detach().cpu() for k, v in m.named_buffers()},
            {k: (v.detach() - start[k]).cpu()
             for k, v in m.named_parameters()})


def det_gaps(got, want):
    """The eval outputs' and the loss's gaps over the largest value, the
    moving stats' (each kind over its largest stat), and each
    parameter's update's ||got - want|| / ||want|| (the largest, and
    the parameter that has it; a vanishing one over the largest norm)."""
    stats = 0.0
    for kind in (".mean", ".var"):
        keys = [k for k in want[2] if k.endswith(kind)]
        scale = max(float(want[2][k].abs().max()) for k in keys)
        stats = max(stats, max(float((got[2][k] - want[2][k]).abs().max())
                               for k in keys) / scale)
    top = max(float(w.abs().max()) for w in want[3].values())
    top_norm = max(float(w.norm()) for w in want[3].values())
    ups = {k: float((got[3][k] - w).norm()) / (
        top_norm if float(w.abs().max()) < VANISHING * top
        else float(w.norm())) for k, w in want[3].items()}
    worst = max(ups, key=ups.get)
    return {"outputs": _rel(got[0], want[0]),
            "loss": abs(got[1] - want[1]) / abs(want[1]),
            "bn_stats": stats, "updates": ups[worst],
            "updates_worst": worst}


def det_held(g):
    return (max(g["outputs"], g["loss"], g["bn_stats"]) <= DET_REL,
            g["updates"] <= DET_UPDATE_REL)


def det_cuda_vs_cpu(dev, seed):
    """(b) One D0 step at batch 2 on the card and on the CPU from the
    same weights, and the wrong-weight yardstick on the card."""
    from tosem_tpu_torch.models.efficientdet import (EfficientDetConfig,
                                                     efficientdet_d0)
    init = {k: v.clone() for k, v in efficientdet_d0(
        device="cpu", seed=seed).state_dict().items()}
    batch = det_batch(EfficientDetConfig.d0(), DET_CHECK_BATCH, seed + 1,
                      "cpu")
    t = time.perf_counter()
    want = det_step("cpu", init, batch)
    cpu_s = time.perf_counter() - t
    got = det_step(dev, init, batch)
    wrong = det_step(dev, init, batch, wrong=True)
    out = {"batch": DET_CHECK_BATCH, "gaps": det_gaps(got, want),
           "wrong_weight_gaps": det_gaps(wrong, want),
           "loss": [got[1], want[1]], "cpu_step_s": cpu_s,
           "limit_rel": DET_REL, "update_limit_rel": DET_UPDATE_REL}
    fwd, bwd = det_held(out["gaps"])
    check(fwd and bwd, f"D0 step card vs CPU: {out}")
    fwd, bwd = det_held(out["wrong_weight_gaps"])
    check(not fwd and not bwd, f"wrong-weight D0 within a limit: {out}")
    return out


def det_cli(dev):
    """(c) The CLI's detection_train, detection_infer and
    pointpillars_infer on the card, into a temporary CSV: AP50 and AP
    with a falling loss; the exported .pt2 reloaded against the eager
    forward; the PointPillars rows at the card grid."""
    import tempfile

    import torch
    from tosem_tpu_torch import cli
    from tosem_tpu_torch.models.efficientdet import efficientdet_tiny
    from tosem_tpu_torch.ops.common import precision
    from tosem_tpu_torch.utils.results import read_results
    out = {}
    with tempfile.TemporaryDirectory(prefix="torch_detection_") as d:
        path = os.path.join(d, "detection.csv")
        for config in ("detection_train", "detection_infer",
                       "pointpillars_infer"):
            t = time.perf_counter()
            check(cli.main([f"--config={config}",
                            f"--results_csv={path}"]) == 0,
                  f"the {config} config failed")
            out[f"{config}_s"] = time.perf_counter() - t
        rows = read_results(path)
        by = {(r["bench_id"], r["metric"]): r for r in rows}
        check(all(r["device"] == "gpu" for r in rows
                  if r["metric"] != "postprocess_ms"),
              "detection rows not on gpu")
        ap = by[("efficientdet_tiny_b2", "ap50")]
        e = ap["extra"]
        check(e["final_loss"] < e["first_loss"],
              f"detection_train loss {e['final_loss']} not below its "
              f"first {e['first_loss']}")
        out["detection_train"] = {
            "ap50": ap["value"], "ap": e["ap"], "steps": e["steps"],
            "first_loss": e["first_loss"], "final_loss": e["final_loss"],
            "step_ms": by[("efficientdet_tiny_b2", "step_time_ms")]["value"]}
        exp = by[("effdet_tiny_export", "export_kb")]
        pt2 = [p for p in exp["extra"]["paths"] if p.endswith(".pt2")][0]
        x = torch.randn(1, 64, 64, 3, generator=torch.Generator()
                        .manual_seed(1)).to(dev)
        # a .pt2 keeps no process-wide switch: fp32 is the caller's
        with precision("float32"), torch.no_grad():
            loaded = torch.export.load(pt2).module()(x)
            eager = efficientdet_tiny(device=dev, seed=0).eval()(x)
        gap = max(_rel(a, b) for a, b in zip(loaded, eager))
        check(gap <= EXPORT_REL, f"reloaded .pt2 vs eager: {gap}")
        out["detection_infer"] = {
            "fwd_ms": by[("effdet_tiny_fwd_b1", "latency_ms")]["value"],
            "postprocess_ms": by[("effdet_tiny_post_b1",
                                  "postprocess_ms")]["value"],
            "export_kb": exp["value"], "reloaded_rel_gap": gap,
            "limit_rel": EXPORT_REL}
        pp = {k[0]: r for k, r in by.items()
              if r["config"] == "pointpillars_infer"}
        check(set(pp) == {"pointpillars_apply_n16384_141x141",
                          "pointpillars_detect_n16384_141x141"},
              f"pointpillars rows {sorted(pp)}")
        out["pointpillars_infer"] = {k: [r["value"],
                                         r["extra"]["clouds_per_sec"]]
                                     for k, r in pp.items()}
    return out


def nms_pairs(boxes, scores, keep, iou_t, score_t):
    """The IoUs the greedy sweep must compute on these inputs: for each
    kept box i in score order, the boxes j > i still live at step i. A
    live box j is suppressed at the first kept i < j that overlaps it
    past ``iou_t`` (and evaluated by every kept box up to it), or kept
    (and evaluated by every kept box before it)."""
    import torch
    from tosem_tpu_torch.ops.nms import iou_matrix, score_order
    order = score_order(scores)
    kept = keep[order]
    live0 = scores[order] > score_t
    n = len(order)
    idx = torch.arange(n, device=boxes.device)
    hit = (iou_matrix(boxes[order]) > iou_t) & kept[:, None] & \
        (idx[:, None] < idx[None, :])
    has = hit.any(0)
    first = hit.float().argmax(0)
    lim = torch.where(has, first, idx - 1)
    ckept = torch.cumsum(kept.long(), 0)
    count = torch.where(lim >= 0, ckept[lim.clamp_min(0)],
                        torch.zeros_like(lim))
    return int((count * live0).sum())


def det_pointpillars(dev, seed):
    """(d) PointPillars at the card grid: ``apply`` on the card against
    the CPU, two ``detect`` launches bit for bit. Returns the record and
    the card's (boxes, scores)."""
    import torch
    from tosem_tpu_torch import cli
    from tosem_tpu_torch.models.pointpillars import (PointPillarsDetector,
                                                     voxelize)
    grid, det, pts = cli.pointpillars_case(torch.device(dev))
    cpu = PointPillarsDetector(grid, device="cpu", seed=0)
    with torch.no_grad():
        boxes, scores = det.apply(pts)
        cb, cs = cpu.apply(pts.cpu())
        masks_equal = torch.equal(voxelize(pts, grid)[1].cpu(),
                                  voxelize(pts.cpu(), grid)[1])
        first = det.detect(pts)
        second = det.detect(pts)
    torch.cuda.synchronize()
    gaps = {"boxes": _rel(boxes.cpu(), cb), "scores": _rel(scores.cpu(), cs)}
    check(masks_equal, "voxelize masks differ card vs CPU")
    check(max(gaps.values()) <= PP_REL, f"PointPillars apply card vs CPU "
          f"{gaps}")
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    check(same, "two detect launches differ")
    return {"grid": [grid.nx, grid.ny, grid.max_points_per_pillar],
            "points": int(pts.shape[0]), "apply_gaps": gaps,
            "limit_rel": PP_REL, "masks_equal": masks_equal,
            "detect_bit_identical": same,
            "kept": int(first[2].sum()),
            "live": int((first[1] > 0.5).sum())}, boxes, scores


def nms_boxes(rng, n, side):
    """n random boxes (x1, y1, x2, y2) over a side x side field, each
    side 0.5-3, as float32 numpy."""
    import numpy as np
    xy = rng.uniform(0, side, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(0.5, 3, (n, 2))],
                          1).astype(np.float32)


NMS_KERNELS = ("nms_gather_kernel", "nms_mask_kernel", "nms_sweep_kernel")


def nms_kernel_ms(b, s, calls=3):
    """Device ms a call of N1's wrapper on (b, s) at the detect
    thresholds, by kernel, from a ``torch.profiler`` trace of ``calls``
    calls: the score sort and the three kernels of ``csrc/nms.cu``. A
    trace that lacks a launch of those kernels (after the script's
    earlier traced phases the profiler has dropped device events) is
    reported as None: not measured."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile
    from tosem_tpu_torch.ops.nms import _nms_cuda
    _nms_cuda(b, s, 0.5, 0.5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            _nms_cuda(b, s, 0.5, 0.5)
        torch.cuda.synchronize()
    per, seen = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("::")[-1].split("(")[0][:60]
            per[name] += e.time_range.elapsed_us() / 1e3 / calls
            seen[name] += 1
    if any(seen[k] != calls for k in NMS_KERNELS):
        return None
    return dict(per.most_common(6))


def det_nms(dev, seed, boxes, scores):
    """The NMS kernel's keep against the plain version's on the card,
    element for element, each case launched twice bit for bit: at the
    card grid's boxes (the detect thresholds, and every box live), at
    NMS_TIE_N boxes with tied scores, at the chunk boundaries
    NMS_EDGE_N, and at the detector's boxes on the NMS_BIG_GRID grid
    (60,025, past the former cap; held against ``nms_plain_rows``, since
    ``nms_plain``'s N x N temporaries outgrow the card there, and that
    yardstick is held to ``nms_plain`` at the card grid first). Then the
    kernel's time at the big grid, and at the card grid by graph replay
    beside the plain version's and its bound from this run's IoU
    count."""
    import numpy as np
    import torch
    from tosem_tpu_torch import cli
    from tosem_tpu_torch.models.pointpillars import (PillarGrid,
                                                     PointPillarsDetector)
    from tosem_tpu_torch.ops.nms import (_nms_cuda, max_boxes, nms_plain,
                                         nms_plain_rows)
    from tosem_tpu_torch.utils.timing import DeviceLoopBench
    rng = np.random.default_rng(seed)
    tb = torch.from_numpy(nms_boxes(rng, NMS_TIE_N, 10)).to(dev)
    ts = torch.from_numpy((rng.integers(0, 4, NMS_TIE_N) / 4).astype(
        np.float32)).to(dev)
    cases = {"grid_detect": (boxes, scores, 0.5, 0.5),
             "grid_all_live": (boxes, scores, 0.5, -1.0),
             f"tied_n{NMS_TIE_N}": (tb, ts, 0.3, 0.2)}
    for n in NMS_EDGE_N:
        # about 64 boxes a 10 x 10 patch, as the tied case
        eb = nms_boxes(rng, n, 10 * max(1.0, (n / 64) ** 0.5))
        es = rng.uniform(0, 1, n).astype(np.float32)
        cases[f"edge_n{n}"] = (torch.from_numpy(eb).to(dev),
                               torch.from_numpy(es).to(dev), 0.5, 0.3)
    grid, _, pts = cli.pointpillars_case(torch.device(dev))
    g = NMS_BIG_GRID
    big = PointPillarsDetector(
        PillarGrid(grid.x_min, grid.x_max, grid.y_min, grid.y_max, g, g,
                   grid.max_points_per_pillar), device=dev, seed=0)
    with torch.no_grad():
        bb, bs = big.apply(pts)
    del big
    big_name = f"grid{g}x{g}_detect"
    cases[big_name] = (bb, bs, 0.5, 0.5)
    out = {"max_boxes": max_boxes(), "cases": {}}
    for name, (b, s, it, st) in cases.items():
        k1 = _nms_cuda(b, s, it, st)
        k2 = _nms_cuda(b, s, it, st)
        if name == big_name:
            plain = nms_plain_rows(b, s, it, st)
        else:
            plain = nms_plain(b, s, it, st)
        torch.cuda.synchronize()
        diff = int((k1 != plain).sum())
        out["cases"][name] = {"n": int(b.shape[0]), "kept": int(k1.sum()),
                              "live": int((s > st).sum()),
                              "differ": diff,
                              "bit_identical": torch.equal(k1, k2)}
        check(diff == 0 and torch.equal(k1, k2),
              f"NMS kernel vs plain, {name}: {out['cases'][name]}")
        if name == "grid_detect":
            rows = nms_plain_rows(b, s, it, st)
            same = torch.equal(rows, plain)
            out["cases"][name]["plain_rows_equal"] = same
            check(same, "nms_plain_rows differs from nms_plain at the "
                  "card grid")
        del k1, k2, plain
    out["big_timing"] = {
        "n": int(bb.shape[0]), "grid": [g, g],
        "ms": DeviceLoopBench(op=lambda x, y: _nms_cuda(x, y, 0.5, 0.5),
                              args=(bb, bs)).time() * 1e3,
        "kernel_ms": nms_kernel_ms(bb, bs)}
    del bb, bs
    torch.cuda.empty_cache()
    b, s = boxes, scores
    ms = DeviceLoopBench(op=lambda x, y: _nms_cuda(x, y, 0.5, 0.5),
                         args=(b, s)).time() * 1e3
    plain_ms = cuda_ms(lambda: nms_plain(b, s, 0.5, 0.5), iters=2, warmup=1)
    pairs = nms_pairs(b, s, _nms_cuda(b, s, 0.5, 0.5), 0.5, 0.5)
    n = int(b.shape[0])
    live = int((s > 0.5).sum())
    bound_ms, bound_by = bound(n * (16 + 4 + 1), pairs * NMS_IOU_OPS,
                               "float32")
    torch.cuda.synchronize()
    out["timing"] = {"n": n, "ms": ms, "plain_ms": plain_ms,
                     "iou_pairs": pairs, "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "design_ious": live * (live - 1) // 2,
                     "sweep_chunks": -(-n // 64),
                     "kernel_ms": nms_kernel_ms(b, s)}
    rec = {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "library_is": "none: no single PyTorch call computes it",
           "dtype": "float32", "shape": [n, 4]}
    return out, rec


def phase_detection(dev, seed):
    """The detection family on the card (see the module docstring).
    Returns the main path's launch counts (the CLI's three entries and
    two detect launches; the kernel-vs-plain checks and timings after
    them do not count) and the NMS kernel's record for the kernels
    line."""
    import torch
    from tosem_tpu_torch.ops import registry
    out = {"phase": "detection", "gpu": gpu_line()}
    secs = {}

    def leg(name, fn, *a):
        t = time.perf_counter()
        r = fn(*a)
        secs[name] = time.perf_counter() - t
        return r
    out["d0_train"] = leg("d0_train", det_d0_train, dev, seed)
    torch.cuda.empty_cache()
    out["d0_cuda_vs_cpu"] = leg("d0_cuda_vs_cpu", det_cuda_vs_cpu, dev, seed)
    torch.cuda.empty_cache()
    registry.reset_launch_counts()
    out["cli"] = leg("cli", det_cli, dev)
    out["pointpillars"], boxes, scores = leg("pointpillars",
                                             det_pointpillars, dev, seed)
    counts = dict(registry.LAUNCH_COUNTS)
    check(counts["nms_sweep"] > 0, "nms_sweep never launched on the "
          "PointPillars path")
    out["launches"] = {k: n for k, n in counts.items() if n}
    out["nms"], rec = leg("nms", det_nms, dev, seed, boxes, scores)
    out["seconds"] = secs
    emit(out)
    return counts, {"nms_sweep": rec}


def phase_suite():
    """North-star config 5 through the port's experiment runner at its
    default BERT-base shapes. Returns the suite's launch counts."""
    import math
    import tempfile

    from tosem_tpu_torch import cli
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.utils.results import read_results
    from tosem_tpu_torch.utils.roofline import PEAK_HBM_GBPS, peak_gflops
    with tempfile.TemporaryDirectory(prefix="torch_kernels_") as d:
        path = os.path.join(d, "torch_kernels.csv")
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(["--config=bert_kernels", f"--results_csv={path}"])
        seconds = time.perf_counter() - t0
        counts = dict(registry.LAUNCH_COUNTS)
        check(rc == 0, f"the bert_kernels leg exited {rc}")
        rows = read_results(path)
    check(len(rows) == 10, f"{len(rows)} suite rows, expected 10")
    out = []
    for r in rows:
        peak = (PEAK_HBM_GBPS if r["unit"] == "GB/s"
                else peak_gflops(r["extra"]["dtype"]))
        check(math.isfinite(r["value"]) and 0 < r["value"] < peak,
              f"{r['bench_id']} reads {r['value']} {r['unit']}, outside "
              f"(0, {peak}): the timing window closed early")
        out.append([r["bench_id"], r["value"], r["unit"],
                    r["extra"]["time_us"], r["value"] / peak])
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "ln_fwd",
                 "ln_bwd", "sm_fwd", "sm_bwd"):
        check(counts[name] > 0, f"{name} never launched in the suite")
    emit({"phase": "suite", "config": "bert_kernels b8 t512 h12 d64 "
          "hidden768 bf16", "seconds": seconds,
          "rows": out, "columns": ["bench_id", "value", "unit", "time_us",
                                   "share_of_peak"], "launches": counts})
    sparse = phase_suite_sparse()
    return {k: counts[k] + sparse[k] for k in counts}


def phase_suite_sparse():
    """The ``flash_sparse`` leg through the runner at its on-chip
    defaults ([1, 12, 8192, 64] bf16; causal, local:1024 and
    doc:2048+causal, fwd and fwd+bwd): 6 rows under the card's peak, each
    row's executed-block fraction equal to the port's program_stats, and
    B1-B3's schedule mode launched. Returns its launch counts."""
    import math
    import tempfile

    from tosem_tpu_torch import cli
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.ops.flash_blocks import BlockSizes
    from tosem_tpu_torch.ops.mask_programs import (mask_from_spec,
                                                   program_stats)
    from tosem_tpu_torch.utils.results import read_results
    from tosem_tpu_torch.utils.roofline import peak_gflops
    with tempfile.TemporaryDirectory(prefix="torch_sparse_") as d:
        path = os.path.join(d, "flash_sparse.csv")
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(["--config=flash_sparse", f"--results_csv={path}"])
        seconds = time.perf_counter() - t0
        counts = dict(registry.LAUNCH_COUNTS)
        check(rc == 0, f"the flash_sparse leg exited {rc}")
        rows = read_results(path)
    check(len(rows) == 6, f"{len(rows)} flash_sparse rows, expected 6")
    specs = {"causal": "causal", "local1024": "local:1024",
             "docpack2048": "doc:2048+causal"}
    out = []
    for r in rows:
        peak = peak_gflops(r["extra"]["dtype"])
        check(math.isfinite(r["value"]) and 0 < r["value"] < peak,
              f"{r['bench_id']} reads {r['value']} {r['unit']}, outside "
              f"(0, {peak})")
        name = r["bench_id"].split("_")[2]
        stats = program_stats(mask_from_spec(specs[name], 8192), 8192, 8192,
                              BlockSizes(), heads=12)
        want = stats["bwd" if "fwdbwd" in r["bench_id"] else "fwd"].fraction
        check(r["extra"]["executed_block_fraction"] == want,
              f"{r['bench_id']}: fraction {r['extra']['executed_block_fraction']}"
              f" != program_stats {want}")
        out.append([r["bench_id"], r["value"], r["unit"],
                    r["extra"]["time_us"], r["value"] / peak,
                    r["extra"]["executed_block_fraction"]])
    for name in SCHED:
        check(counts[name] > 0, f"{name} never launched in flash_sparse")
    emit({"phase": "suite_sparse", "config": "flash_sparse b1 t8192 h12 d64 "
          "bf16", "seconds": seconds, "rows": out,
          "columns": ["bench_id", "value", "unit", "time_us",
                      "share_of_peak", "executed_block_fraction"],
          "launches": counts})
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,decode,decode_modes,encode,"
                            "serve,cluster,encode_sparse,cpu,profile,train,"
                            "train_dp,parallel,pipeline,mesh_train,benches,"
                            "configs,kernel_matrix,moe,speech,detection,"
                            "suite")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not os.path.isdir(os.path.join(ROOT, "tosem_tpu_torch")):
        print("tosem_tpu_torch/ is not beside chip_smoke.py: run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs a "
              "CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tosem_tpu_torch.ops import _build
    dev = "cuda"
    gpu = gpu_line()
    t0 = time.perf_counter()
    took = _build.build_all(verbose_ptxas=True)
    bodies, faults = bwd_tc_report()
    rows, row_faults = warp_row_report()
    paged, paged_faults = paged_report()
    nms, nms_faults = nms_report()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": took, "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "ptxas": {k: ptxas_summary(v[1])
                    for k, v in _build.BUILD_LOG.items()},
          "bwd_bf16_bodies": bodies, "warp_row_bodies": rows,
          "paged_bodies": paged, "nms_kernels": nms})
    check(not faults, "bf16 B2/B3 bodies: " + "; ".join(faults))
    check(not row_faults,
          "B6/B7/B8 warp-row bodies: " + "; ".join(row_faults))
    check(not paged_faults, "B4/B5 chunk bodies: " + "; ".join(paged_faults))
    check(not nms_faults, "N1's kernels: " + "; ".join(nms_faults))
    secs = {"build": time.perf_counter() - t0}

    def timed(name, fn, *a):
        t = time.perf_counter()
        try:
            return fn(*a)
        finally:
            secs[name] = secs.get(name, 0.0) + time.perf_counter() - t

    lines = timed("kernels", phase_kernels, dev, SEED) \
        if "kernels" in phases else {}
    launches = {k: 0 for k in KERNELS}
    direct = None

    def add(counts):
        for k, n in counts.items():
            launches[k] += n
    if "decode" in phases:
        counts, direct = timed("decode", phase_decode, dev, SEED,
                               NEW_TOKENS)
        add(counts)
    if "decode_modes" in phases:
        add(timed("decode_modes", phase_decode_modes, dev, SEED, NEW_TOKENS,
                  direct))
    if "encode" in phases:
        add(timed("encode", phase_encode, dev, SEED))
    if "serve" in phases:
        add(timed("serve", phase_serve, dev, SEED, NEW_TOKENS, direct))
    if "cluster" in phases:
        add(timed("cluster", phase_cluster, dev, SEED, NEW_TOKENS, direct))
    if "encode_sparse" in phases:
        add(timed("encode_sparse", phase_encode_sparse, dev, SEED))
    if "cpu" in phases:
        timed("cpu", phase_cpu, dev, SEED)
    if "profile" in phases:
        timed("profile", phase_profile, dev, SEED)
    if "train" in phases:
        add(timed("train", phase_train, dev, SEED))
        timed("train", phase_train_grads, dev, SEED)
        timed("train", phase_train_remat, dev, SEED)
        timed("train", phase_train_resume, dev, SEED)
    if "train_dp" in phases:
        add(timed("train_dp", phase_train_dp, dev, SEED))
    if "parallel" in phases:
        add(timed("parallel", phase_parallel, dev, SEED))
    if "pipeline" in phases:
        add(timed("pipeline", phase_pipeline, dev, SEED))
    if "mesh_train" in phases:
        add(timed("mesh_train", phase_mesh_train, dev, SEED))
    if "benches" in phases:
        add(timed("benches", phase_benches, dev, SEED))
    if "configs" in phases:
        timed("configs", phase_configs, dev, SEED)
    if "kernel_matrix" in phases:
        timed("kernel_matrix", phase_kernel_matrix, dev, SEED)
    if "moe" in phases:
        add(timed("moe", phase_moe, dev, SEED))
    if "speech" in phases:
        timed("speech", phase_speech, dev, SEED)
    if "detection" in phases:
        counts, rec = timed("detection", phase_detection, dev, SEED)
        add(counts)
        lines.update(rec)
    if "suite" in phases:
        add(timed("suite", phase_suite))
    emit({"phase": "seconds", **secs,
          "total": time.perf_counter() - t0})
    src = "tosem_tpu_torch/ops/csrc/"
    meta = {"flash_fwd": ("flash_fwd.cu",
                          "tosem_tpu/ops/flash_attention.py:272"),
            "flash_bwd_dkv": ("flash_bwd.cu",
                              "tosem_tpu/ops/flash_attention.py:402"),
            "flash_bwd_dq": ("flash_bwd.cu",
                             "tosem_tpu/ops/flash_attention.py:471"),
            "paged_decode": ("paged_decode.cu",
                             "tosem_tpu/ops/paged_attention.py:101"),
            "paged_decode_multi": ("paged_decode.cu",
                                   "tosem_tpu/ops/paged_attention.py:225"),
            "ln_fwd": ("fused_norms.cu", "tosem_tpu/ops/fused_norms.py:39"),
            "ln_bwd": ("fused_norms.cu", "tosem_tpu/ops/fused_norms.py:55"),
            "sm_fwd": ("fused_norms.cu", "tosem_tpu/ops/fused_norms.py:145"),
            "sm_bwd": ("fused_norms.cu", "tosem_tpu/ops/fused_norms.py:152"),
            "flash_fwd_sched": ("flash_fwd.cu",
                                "tosem_tpu/ops/flash_attention.py:272"),
            "flash_bwd_dkv_sched": ("flash_bwd.cu",
                                    "tosem_tpu/ops/flash_attention.py:402"),
            "flash_bwd_dq_sched": ("flash_bwd.cu",
                                   "tosem_tpu/ops/flash_attention.py:471"),
            "nms_sweep": ("nms.cu", "tosem_tpu/models/pointpillars.py:155")}
    kernels = []
    for name, (f, replaces) in meta.items():
        rec = lines.get(name, {})
        kernels.append({"name": name, "route": "cuda", "source": src + f,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": rec.get("max_abs_err"),
                        "ms": rec.get("ms"), "plain_ms": rec.get("plain_ms"),
                        "bound_ms": rec.get("bound_ms"),
                        "bound_by": rec.get("bound_by"),
                        "library_ms": rec.get("library_ms"),
                        "library_is": rec.get("library_is"),
                        "port_fwd_bwd_ms": rec.get("port_fwd_bwd_ms"),
                        "port_bwd_ms": rec.get("port_bwd_ms"),
                        "sdpa_fwd_bwd_ms": rec.get("sdpa_fwd_bwd_ms"),
                        "dtype": rec.get("dtype"),
                        "shape": rec.get("shape") or rec.get("lens")})
    print(gpu, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
