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
              STG.E.128) and spill nothing, and every instantiation of
              B4/B5's chunk body 16-byte global loads and no spill.
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
              handing each sequence over by export to a decode replica
              of 16 pages) serves the 8 prompts at once: streams equal
              the direct ones, spills, restores and 8 migrations with no
              fallback. After shutdown no replica process may hold the
              card. Prints TTFT through HTTP, served tokens/s and ms a
              scheduler step beside the replica's own admit and step
              times, and the micro-batches the queue formed.
4b. encode_sparse — long-document BERT-base encode: ``BertEncodeBackend``
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
7. train    — the BERT-base masked-LM train step of the JAX package's
              ``bert_train`` leg (8 x 512, bf16, dropout 0.1, adamw(1e-4))
              through ``make_train_step``: 10 timed steps with flash
              attention (B1 forward, B2 and B3 backward) whose loss must
              fall, the same steps with dense attention, a padded batch
              (the kernels' segment mode), fp32 gradients checked flash
              against dense and card against CPU (with a wrong-model
              yardstick), remat full/dots against none bit for bit,
              ``fit`` resumed after a preemption bit for bit, and a
              profile of the flash and of the dense step.
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
              each timing calibrated to 20 ms windows),
              each row beside the card's name and power limit; on one
              card the "bus" is its memory.
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

``--phases`` picks a subset (default: all thirteen), e.g. ``build,kernels``
for a first call after a kernel change, ``build,kernels,train`` for the
training path, ``build,train_dp`` for data-parallel training,
``build,parallel`` for the device mesh,
``build,kernels,suite`` for the kernel suite,
``build,decode,serve`` for the served path, or
``build,kernels,decode,decode_modes,serve`` for the decode modes.

The launch counts of every kernel are set to 0 just before the decode,
each decode mode, the encode, the sparse encode, the train, each
data-parallel run, each sharded path and the suite paths run and
read just after (the serve path's inside its replicas: set to 0 as
deploy's warm-up ends, read after the traffic); a kernel of the path
that never launched fails the run. Before the last line it prints the card's name and
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
           "flash_fwd_sched", "flash_bwd_dkv_sched", "flash_bwd_dq_sched")
SCHED = ("flash_fwd_sched", "flash_bwd_dkv_sched", "flash_bwd_dq_sched")
# B1-B3's schedule mode is checked at [2, SCHED_T, 12, 64] under these
# mask programs ("mh": 12 heads alternating CausalMask and LocalMask(128);
# "+segments": segment ids on top of the schedule)
SCHED_T = 1024
SPARSE_T = 8192     # the flash_sparse leg's sequence length
SCHED_MASKS = ("local:256", "local:128:127", "doc:256", "doc:256+causal",
               "prefix:200", "mh", "doc:256+segments")

# how the profiler names the kernels of tosem_tpu_torch/ops/csrc
PORT_KERNEL_NAMES = tuple(f"void (anonymous namespace)::{k}_"
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


def hold_rows(what, want, got, extra=None, exact=False):
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
    emit({"phase": "decode_modes", f"{what}_rows": rec})
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

    def reset_counts():
        from tosem_tpu_torch.nn.attention import FLASH_DISPATCH_COUNTS
        from tosem_tpu_torch.ops import registry
        registry.reset_launch_counts()
        FLASH_DISPATCH_COUNTS.clear()
        FLASH_DISPATCH_COUNTS.update({"flash": 0, "dense": 0})

    def replica_stats(out):
        from tosem_tpu_torch.ops import registry
        out["launch_counts"] = dict(registry.LAUNCH_COUNTS)
        out["pid"] = os.getpid()
        return out

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


def stream_post(url, payload, t_start):
    """POST one streamed decode and read its chunks as they arrive:
    (seconds from ``t_start`` to the first chunk and to the end, the
    streamed tokens, the final result)."""
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    first, tokens, result = None, [], None
    with urllib.request.urlopen(req, timeout=120) as r:
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
    check(result is not None, f"POST {url}: the stream ended without a "
          "result")
    return first, time.perf_counter() - t_start, tokens, result


def post_at_once(url, prompts):
    """Stream one decode of each prompt, all released together from one
    client thread each; returns each one's :func:`stream_post` result."""
    import threading
    got = [None] * len(prompts)
    errors = []
    gate = threading.Barrier(len(prompts) + 1)
    t_send = [0.0]

    def client(i):
        try:
            gate.wait()
            got[i] = stream_post(url, {"ids": prompts[i]}, t_send[0])
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
    disaggregated deployment (a prefill replica handing each sequence to
    a decode replica of 16 pages by export, which must spill). ``direct``
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
          "hit_equals_cold": True, "encode_bit_exact": True})
    return {k: dl.get(k, 0) + el.get(k, 0) + dis_l[k] for k in KERNELS}


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


def phase_train(dev, seed, steps=10, warmup=2):
    """The JAX package's ``bert_train`` leg (``tosem_tpu/cli.py``) on the
    port: BERT-base, bf16, dropout 0.1, weights from ``seed``, adamw(1e-4),
    an 8 x 512 batch of random ids from ``seed + 1`` with labels = ids and
    15% of positions masked. Flash attention (B1, B2, B3) against dense
    attention on the same weights and batch; the train FLOPs are the
    reference's count, 6*N*B*T + 3*12*L*B*T^2*dim."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tosem_tpu_torch.models.bert import Bert, BertConfig
    from tosem_tpu_torch.nn.attention import flash_attn_fn
    from tosem_tpu_torch.ops import registry
    from tosem_tpu_torch.train.trainer import step_generator
    cfg = BertConfig.base()
    B, T = 8, 512
    rng = np.random.default_rng(seed + 1)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                          device=dev)
    masked = torch.as_tensor(rng.random((B, T)) < 0.15, device=dev)
    batch = _mlm_batch(ids, masked)
    model = Bert(cfg, device=dev, seed=seed)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    flops = 6 * n_params * B * T + 3 * 12 * cfg.layers * B * T * T * cfg.dim

    st, step, losses, flash_ms, counts = train_steps(
        model, init, batch, flash_attn_fn(), seed, warmup, steps)
    check(all(np.isfinite(losses)), f"non-finite train loss {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        check(counts[name] == 12 * steps,
              f"{name}: {counts[name]} launches in {steps} train steps")

    # one step on a padded batch: key padding rides B1-B3 as segment ids
    lens = [int(n) for n in rng.integers(30, 501, size=B)]
    pmask = torch.zeros(B, T, dtype=torch.int32)
    for b, n in enumerate(lens):
        pmask[b, :n] = 1
    pmask = pmask.to(dev)
    pbatch = _mlm_batch(ids * pmask, masked & pmask.bool(), pmask)
    registry.reset_launch_counts()
    st, met = step(st, pbatch, step_generator(seed, warmup + steps, dev))
    padded_loss = float(met["loss"])
    pcounts = dict(registry.LAUNCH_COUNTS)
    check(np.isfinite(padded_loss), f"padded batch loss {padded_loss}")
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        check(pcounts[name] == 12, f"{name}: {pcounts[name]} launches on "
                                   "the padded batch")
    launches = {k: counts[k] + pcounts[k] for k in KERNELS}

    # where the time goes: one step without the profiler, one under it
    wall = _timed(lambda: step(st, batch, step_generator(seed, 90, dev)))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    traced = _timed(lambda: step(st, batch, step_generator(seed, 91, dev)),
                    prof)
    breakdown = _device_breakdown(prof, wall, traced, 1, top=12)
    del st, step, prof
    torch.cuda.empty_cache()

    st, step, dense_losses, dense_ms, _ = train_steps(
        model, init, batch, None, seed, warmup, steps)
    check(all(np.isfinite(dense_losses)), f"dense loss {dense_losses}")
    mem = torch.cuda.max_memory_allocated() / 2**30
    wall = _timed(lambda: step(st, batch, step_generator(seed, 92, dev)))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    traced = _timed(lambda: step(st, batch, step_generator(seed, 93, dev)),
                    prof)
    dense_breakdown = _device_breakdown(prof, wall, traced, 1, top=12)
    del st, step, model, init, prof
    torch.cuda.empty_cache()
    emit({"phase": "train", "config": "BERT-base bf16 dropout 0.1",
          "batch": [B, T], "params": n_params, "flops_per_step": flops,
          "warmup": warmup, "steps": steps, "losses": losses,
          "step_ms": flash_ms, "tokens_per_s": B * T / flash_ms * 1e3,
          "share_of_989_tflops": flops / (flash_ms * 1e-3) / 989e12,
          "dense_losses": dense_losses, "dense_step_ms": dense_ms,
          "dense_tokens_per_s": B * T / dense_ms * 1e3,
          "flash_vs_dense_speedup": dense_ms / flash_ms,
          "padded_lens": lens, "padded_loss": padded_loss,
          "launches_timed_steps": counts, "launches_padded_step": pcounts,
          "max_memory_gib": mem, "profile": breakdown,
          "dense_profile": dense_breakdown})
    return launches


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
                            "serve,encode_sparse,cpu,profile,train,"
                            "train_dp,parallel,suite")
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
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": took, "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "ptxas": {k: ptxas_summary(v[1])
                    for k, v in _build.BUILD_LOG.items()},
          "bwd_bf16_bodies": bodies, "warp_row_bodies": rows,
          "paged_bodies": paged})
    check(not faults, "bf16 B2/B3 bodies: " + "; ".join(faults))
    check(not row_faults,
          "B6/B7/B8 warp-row bodies: " + "; ".join(row_faults))
    check(not paged_faults, "B4/B5 chunk bodies: " + "; ".join(paged_faults))
    lines = phase_kernels(dev, SEED) if "kernels" in phases else {}
    launches = {k: 0 for k in KERNELS}
    direct = None
    if "decode" in phases:
        counts, direct = phase_decode(dev, SEED, NEW_TOKENS)
        for k, n in counts.items():
            launches[k] += n
    if "decode_modes" in phases:
        for k, n in phase_decode_modes(dev, SEED, NEW_TOKENS,
                                       direct).items():
            launches[k] += n
    if "encode" in phases:
        for k, n in phase_encode(dev, SEED).items():
            launches[k] += n
    if "serve" in phases:
        for k, n in phase_serve(dev, SEED, NEW_TOKENS, direct).items():
            launches[k] += n
    if "encode_sparse" in phases:
        for k, n in phase_encode_sparse(dev, SEED).items():
            launches[k] += n
    if "cpu" in phases:
        phase_cpu(dev, SEED)
    if "profile" in phases:
        phase_profile(dev, SEED)
    if "train" in phases:
        for k, n in phase_train(dev, SEED).items():
            launches[k] += n
        phase_train_grads(dev, SEED)
        phase_train_remat(dev, SEED)
        phase_train_resume(dev, SEED)
    if "train_dp" in phases:
        for k, n in phase_train_dp(dev, SEED).items():
            launches[k] += n
    if "parallel" in phases:
        for k, n in phase_parallel(dev, SEED).items():
            launches[k] += n
    if "suite" in phases:
        for k, n in phase_suite().items():
            launches[k] += n
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
                                   "tosem_tpu/ops/flash_attention.py:471")}
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
