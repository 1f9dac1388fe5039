"""Distributed-training microbench (the train leg of the bench suites).

Three legs on the threads backend over real transport sockets (the same
fold and chain code the nodes backend runs), following the bench-noise
protocol: interleaved A/B rounds so both arms share the host phase, the
per-round values on each row, and in-round ratios:

- **Overlap vs serialized comms** on a comms-dominated staged model
  (8 towers ⇒ 8 buckets; a deep-linear backward sized to the wire time):
  the bucketed chain reduce launched per stage hides behind the
  remaining backward. The gradient streams ride a PACED wire
  (``DataParallelConfig.wire_bps``, 40 MB/s): a loopback transfer is
  host CPU work, so nothing could hide behind an unpaced one; pacing
  restores the cross-node regime — wire time the host CPUs do not pay.
- **Async vs sync checkpointing**: the ON-STEP cost of a checkpoint —
  wall time the training loop spends inside the save call each step —
  sync (serialize + per-file fsync + manifest hash for a 128-leaf tree)
  vs async (owned host snapshot + join of the previous write). Each
  save follows a compute step (a 32-deep 512x512 matmul chain), the
  window the background write drains into.
- **dp parity pin**: dp=4 over the transport chain vs the
  single-process local fold — identical loss trajectories, raised on;
  the row exists so a reader sees the pin ran.

A copy of the JAX package's ``train/bench_train.py``. The reference
asserts two speed floors, set on its 2-CPU host: overlap ≥ 1.3x the
serialized arm, and async removing ≥ 0.8 of the on-step checkpoint cost.
No speed target carries over to the port (ROADMAP.md's ground rules), so
each ratio row carries the reference's floor and ``floor_met`` in
``extra`` and the bench does not raise on it. The parity pin raises.
The jobs and the checkpointed tree live on ``device`` (the card unless
the caller asks for the CPU); what the legs time is host machinery.

``python -m tosem_tpu_torch.cli --config=train_bench`` runs it.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import List, Optional

from tosem_tpu_torch.serve.bench_common import SuiteEmitter
from tosem_tpu_torch.utils.results import ResultRow

# the JAX package's perf-gated rows of this suite
GATED_TRAIN_BENCHES = (
    "train_step_overlap", "train_overlap_speedup",
    "train_ckpt_async_overhead_ms", "train_ckpt_async_saving",
    "train_dp_parity",
)

# the reference's speed floors, reported beside each ratio, never raised
SPEED_FLOORS = {"train_overlap_speedup": 1.3,
                "train_ckpt_async_saving": 0.8}

# comms-dominated synthetic: 8 towers x 256x256 fp32 = 8 buckets of
# 256 KB gradient each per step; depth=8 deepens backward (FLOPs
# without payload) so backward wall ~ wire wall at 40 MB/s — the
# regime where serializing comms visibly stretches the step and
# overlap hides it behind the remaining towers' backward
_OVERLAP_JOB = dict(towers=8, dim=256, batch=64, grain=4, seed=11,
                    depth=8)
_OVERLAP_WIRE_BPS = 40e6
_PARITY_JOB = dict(towers=3, dim=16, batch=16, grain=4, seed=7)

_JOB_REF = "tosem_tpu_torch.train.distributed:demo_job"


def _steps_per_s(trainer, overlap: bool, min_s: float) -> float:
    trainer.overlap = overlap
    target = len(trainer.history) + 2
    t0 = time.perf_counter()
    n = 0
    while True:
        trainer.fit(target)
        n += 2
        target += 2
        dt = time.perf_counter() - t0
        if dt >= min_s:
            return n / dt


def _bench_overlap(em: SuiteEmitter, trials: int, min_s: float,
                   device: str) -> None:
    ids = {"train_step_overlap", "train_step_serial",
           "train_overlap_speedup"}
    if not any(em.want(b) for b in ids):
        return
    from tosem_tpu_torch.train.distributed import (DataParallelConfig,
                                                   DistributedTrainer)
    cfg = DataParallelConfig(grain=4, bucket_bytes=1 << 20,
                             job="bench-overlap",
                             transport_capacity=64 << 20,
                             wire_bps=_OVERLAP_WIRE_BPS)
    tr = DistributedTrainer(_JOB_REF, dict(_OVERLAP_JOB, device=device),
                            cfg, backend="threads", world=4)
    try:
        _steps_per_s(tr, True, 0.2)          # warmup: kernels + sockets
        ov, se, ratios = [], [], []
        for _ in range(trials):
            a = _steps_per_s(tr, True, min_s)
            b = _steps_per_s(tr, False, min_s)
            ov.append(a)
            se.append(b)
            ratios.append(a / b)
    finally:
        tr.close()
    em.emit("train_step_overlap",
            "dp4 steps overlapped comms", ov, unit="steps/s")
    em.emit("train_step_serial",
            "dp4 steps serialized comms", se, unit="steps/s")
    em.emit_floored("train_overlap_speedup",
                    "train overlap over serialized", ratios,
                    SPEED_FLOORS["train_overlap_speedup"])


def _bench_parity(em: SuiteEmitter, device: str) -> None:
    if not em.want("train_dp_parity"):
        return
    from tosem_tpu_torch.train.distributed import (DataParallelConfig,
                                                   DistributedTrainer,
                                                   demo_job,
                                                   make_dp_train_step)
    job = demo_job(**_PARITY_JOB, device=device)
    state = job.init_state()
    step_fn = make_dp_train_step(job)
    ref = []
    for _ in range(5):
        state, m = step_fn(state)
        ref.append(m["loss"])
    cfg = DataParallelConfig(grain=4, bucket_bytes=1024,
                             job="bench-parity",
                             transport_capacity=8 << 20)
    tr = DistributedTrainer(_JOB_REF, dict(_PARITY_JOB, device=device),
                            cfg, backend="threads", world=4)
    try:
        hist = tr.fit(5)
    finally:
        tr.close()
    if hist != ref:
        raise RuntimeError(
            f"dp=4 loss trajectory diverged from the single-process "
            f"fold: {hist} vs {ref} — the bit-identity contract is broken")
    em.emit("train_dp_parity", "dp4 vs single-process bit-identity",
            [1.0], unit="identical")


def _bench_ckpt(em: SuiteEmitter, trials: int, min_s: float,
                device: str) -> None:
    ids = {"train_ckpt_sync_overhead_ms", "train_ckpt_async_overhead_ms",
           "train_ckpt_async_saving"}
    if not any(em.want(b) for b in ids):
        return
    import torch

    from tosem_tpu_torch.ops.common import resolve_device
    from tosem_tpu_torch.train.checkpoint import (AsyncCheckpointer,
                                                  save_versioned)

    # 128 leaves × 64 KB: the write pays per-file write+fsync plus the
    # manifest's re-read+hash — the on-step cost the async writer
    # removes; the K=32 matmul chain is the compute window the
    # background write drains into before the next save's join
    dev = resolve_device(device)
    L, d, K = 128, 128, 32

    def init():
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "c": torch.ones((512, 512), device=dev),
                "params": {f"p{i:03d}": torch.ones((d, d), device=dev)
                           for i in range(L)}}

    def step(state):
        m = state["c"]
        for _ in range(K):
            m = (m @ m) * (1.0 / 512.0)
        params = {k: w * 0.999 for k, w in state["params"].items()}
        return {"step": state["step"] + 1, "c": m, "params": params}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    steps = 8
    st = step(init())
    sync()                                             # warm-up
    sync_ms, async_ms, savings = [], [], []
    root = tempfile.mkdtemp(prefix="bench_train_ckpt_")
    try:
        for t in range(trials):
            # interleaved A/B: each arm runs the same compute/save
            # cadence in the same host phase; the timed region is the
            # save call alone (what the loop stops for)
            d_sync = os.path.join(root, f"s{t}")
            st = init()
            costs = []
            for s in range(steps):
                st = step(st)
                sync()
                t0 = time.perf_counter()
                save_versioned(d_sync, s + 1, st, keep=2)
                costs.append(time.perf_counter() - t0)
            os_ms = sum(costs) / steps * 1e3

            d_async = os.path.join(root, f"a{t}")
            st = init()
            costs = []
            with AsyncCheckpointer(d_async, keep=2) as saver:
                for s in range(steps):
                    st = step(st)
                    sync()
                    t0 = time.perf_counter()
                    saver.save(s + 1, st)
                    costs.append(time.perf_counter() - t0)
            oa_ms = sum(costs) / steps * 1e3
            sync_ms.append(os_ms)
            async_ms.append(oa_ms)
            savings.append(1.0 - oa_ms / os_ms)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    em.emit("train_ckpt_sync_overhead_ms",
            "sync checkpoint on-step overhead", sync_ms, unit="ms",
            lower_is_better=True)
    em.emit("train_ckpt_async_overhead_ms",
            "async checkpoint on-step overhead", async_ms, unit="ms",
            lower_is_better=True)
    em.emit_floored("train_ckpt_async_saving",
                    "fraction of on-step checkpoint cost removed", savings,
                    SPEED_FLOORS["train_ckpt_async_saving"], unit="ratio")


def run_train_benchmarks(trials: int = 3, min_s: float = 0.4,
                         quiet: bool = False,
                         only: Optional[set] = None,
                         device: str = "cuda") -> List[ResultRow]:
    em = SuiteEmitter("train", only=only)
    _bench_parity(em, device)
    _bench_overlap(em, trials, min_s, device)
    _bench_ckpt(em, trials, min_s, device)
    return em.flush(quiet)
