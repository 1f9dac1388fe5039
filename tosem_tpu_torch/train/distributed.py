"""Distributed data-parallel training over the tensor transport.

The port's counterpart of ``tosem_tpu/train/distributed.py``, in
PyTorch's idiom. The design center is the reproducibility contract, and
everything else falls out of it:

- **Logical shards, physical workers.** A job's data parallelism is a
  fixed ``grain`` of L *logical shards* per step — shard ``s`` gets
  rows ``[s·B/L, (s+1)·B/L)`` of the global batch and a generator on
  the job's device seeded by ``fold_in(fold_in(seed, step), s)`` (the
  trainer's per-step :func:`~tosem_tpu_torch.train.trainer.fold_in`,
  extended per shard). Workers own *contiguous runs* of shards;
  membership changes (a lost worker ⇒ shrink, a new one ⇒ grow) only
  move shard boundaries, never the shards themselves.
- **Strict left-fold reduction.** The global gradient is the strict
  left fold ``((g₀+g₁)+g₂)+…`` over logical shards, in shard order, of
  host copies of each shard's gradients. A chain all-reduce threads the
  running partial through the workers in rank order; each worker folds
  its own shards' gradients one at a time onto the incoming partial, so
  the *grouping* of the float additions is identical for every world
  size — dp=4 ``fit()`` is bit-identical to single-process ``fit()`` at
  equal global batch, and stays bit-identical through a mid-run shrink
  or grow. It rests on every op of a shard's step giving the same bits
  for the same rows whatever runs beside it (no atomics that add into
  one address from several threads).
- **Two reduction lowerings.** The trainer's fold rides
  :mod:`tosem_tpu_torch.cluster.transport` chunked streams
  worker→worker. The single-process arm
  ``make_dp_train_step(reduce="shard_map")`` computes each shard's
  gradients in a position of a dp mesh
  (:func:`tosem_tpu_torch.parallel.spmd.shard_map`) and sums them on the
  device with ``psum``, the same left fold in shard order.
- **Bucketed all-reduce overlapped with backward.** Parameters are
  grouped into size-targeted buckets (:func:`partition_buckets`;
  uneven tails and oversized leaves get their own buckets). Jobs that
  declare *gradient stages* (disjoint parameter groups whose losses are
  independent — the DDP bucket-hook analog) have each bucket's chain
  reduce launched the moment its stage's backward completes, so comms
  hide behind the remaining backward compute; ``overlap=False`` keeps
  the serialized-comms mode as the measured baseline arm.

The worker (:class:`TrainWorkerBackend`) runs in-process
(``backend="threads"``: each rank is a thread of the trainer's process,
launching its shards' work on the job's device from that thread; on a
GPU, every rank's kernels go to the device's current stream, the same
one for all) or as a replica process on a node agent
(``backend="nodes"``: ranks gang-reserved over a
:class:`~tosem_tpu_torch.cluster.supervisor.NodePool`'s agents, strategy
``"spread"``, each spawned through
:func:`~tosem_tpu_torch.serve.replica_worker.resolve_backend` and steered
over the RPC plane's ``backend_call``; each builds its own job from the
job ref, on its own device, and the head's journal records
``train_started``, ``train_worker_placed``, ``train_worker_lost``,
``train_shrunk`` and ``train_grown``). A node's death shrinks the world
exactly as a lost thread does. Gradients cross to the host by an
explicit copy, and parameter traffic (elastic catch-up, grow bootstrap,
:meth:`DistributedTrainer.fetch_state`) rides the same transport streams
as gradients.
"""
from __future__ import annotations

import collections
import functools
import importlib
import json
import statistics
import threading
import time
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tosem_tpu_torch.chaos import hooks as _chaos
from tosem_tpu_torch.cluster.fencing import StaleEpochError
from tosem_tpu_torch.cluster.transport import (TensorReceiver,
                                               TransportError, send_tensors)
from tosem_tpu_torch.obs import metrics as _metrics
from tosem_tpu_torch.train.trainer import fold_in

__all__ = [
    "DataParallelConfig", "DPJob", "DPState", "Bucket",
    "partition_buckets", "ChainReducer", "TrainWorkerBackend",
    "DistributedTrainer", "fit_distributed", "make_dp_train_step",
    "demo_job", "jobs_stats", "TrainWorkerLost", "dp_params_from_numpy",
]

_LOSS_KEY = "___loss"


class TrainWorkerLost(RuntimeError):
    """Every worker (or the last usable configuration) was lost."""


# --------------------------------------------------------------- config


@dataclass
class DataParallelConfig:
    """Knobs of one data-parallel job. ``grain`` is the number of
    logical shards — FIXED for the job's lifetime (it defines the
    reduction order and therefore the loss trajectory); the worker
    count is what flexes under elasticity, bounded by ``1 <= world <=
    grain``. ``transport_capacity`` is each rank's receive segment: a
    rank holds at most one incoming partial and one final sum of every
    bucket at once, so twice the gradient bytes never spills to the
    heap."""

    grain: int = 4
    bucket_bytes: int = 1 << 20
    overlap: bool = True
    job: str = "train"
    transport_capacity: int = 32 << 20
    chunk_bytes: int = 1 << 18
    reduce_timeout: float = 120.0
    # emulated interconnect bandwidth for the gradient streams
    # (bytes/s; None = unpaced loopback), see send_tensors' pace_bps
    wire_bps: Optional[float] = None
    # slow-rank watchdog: evict a rank whose median LOCAL backward
    # time exceeds straggler_factor × the fleet median (chain sync
    # equalizes end-to-end step times, so the trainer keys off each
    # rank's self-reported compute_ms instead). 0.0 = off — the
    # default, because a 2-rank fleet under CI jitter must never
    # self-drain. The eviction rides the SAME shrink path as a lost
    # worker, so a gray-slow rank costs one detection window rather
    # than a reduce_timeout stall per step.
    straggler_factor: float = 0.0
    straggler_min_samples: int = 3
    straggler_min_s: float = 0.05

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "DataParallelConfig":
        return cls(**(d or {}))


# --------------------------------------------------------------- buckets


@dataclass(frozen=True)
class Bucket:
    """One all-reduce unit: a run of consecutive gradient leaves of one
    stage, targeted at ``bucket_bytes`` (an oversized leaf rides
    alone — the uneven tail case)."""

    bid: int
    stage: int
    leaves: Tuple[int, ...]
    nbytes: int


def partition_buckets(leaf_meta: Sequence[Tuple[int, int]],
                      bucket_bytes: int) -> List[Bucket]:
    """Group leaves (``(nbytes, stage)`` per flat-leaf index, in leaf
    order) into size-targeted buckets. Buckets never span stages (a
    bucket's readiness is its stage's backward completing); a leaf that
    alone exceeds ``bucket_bytes`` still gets a bucket (its own);
    dtype-mixed trees work because leaves are never concatenated, only
    grouped."""
    if bucket_bytes < 1:
        raise ValueError("bucket_bytes must be >= 1")
    out: List[Bucket] = []
    cur: List[int] = []
    cur_bytes = 0
    cur_stage = -1

    def flush():
        nonlocal cur, cur_bytes
        if cur:
            out.append(Bucket(bid=len(out), stage=cur_stage,
                              leaves=tuple(cur), nbytes=cur_bytes))
            cur, cur_bytes = [], 0

    for i, (nb, st) in enumerate(leaf_meta):
        if cur and (st != cur_stage or cur_bytes + nb > bucket_bytes):
            flush()
        cur.append(i)
        cur_bytes += int(nb)
        cur_stage = int(st)
    flush()
    return out


# ------------------------------------------------------------ param trees
#
# A parameter tree is a nested dict of tensors. Its leaves are taken in
# sorted-key order at every level, the order jax.tree_util gives the
# reference's dicts, so leaf i names the same parameter in both packages.


def _leaves(tree: Any) -> List[torch.Tensor]:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    raise TypeError(f"a parameter tree holds dicts and tensors, not "
                    f"{type(tree).__name__}")


def _unflatten(template: Any, leaves: Sequence[Any]) -> Any:
    it = iter(leaves)

    def build(node):
        if torch.is_tensor(node):
            return next(it)
        return {k: build(node[k]) for k in sorted(node)}
    return build(template)


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_bf16(tree: Any) -> Any:
    return _tree_map(lambda x: x.to(torch.bfloat16)
                     if torch.is_floating_point(x) else x, tree)


# ------------------------------------------------------- the fold (spec)


def _fold(acc: Optional[Dict[str, torch.Tensor]],
          g: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One left-fold step of the canonical reduction. This helper IS
    the reduction spec: every arm (local reference, chain transport)
    sums through it, so the float grouping can never diverge."""
    if acc is None:
        return g
    return {k: torch.add(acc[k], g[k]) for k in acc}


def _mean_loss(total: np.floating, grain: int) -> float:
    """Canonical loss normalization (shared by every arm)."""
    return float(np.float32(total) / np.float32(grain))


# --------------------------------------------------------------- the job


class DPState:
    """A job's replicated state: the step count, the stage-keyed
    parameters (leaf tensors on the job's device) and the optimizer over
    them. ``state_dict``/``load_state_dict`` make it a checkpoint tree
    and the payload of a parameter stream."""

    def __init__(self, step: int, params: Dict[str, Any],
                 optimizer: torch.optim.Optimizer):
        self.step = int(step)
        self.params = params
        self.optimizer = optimizer

    def leaves(self) -> List[torch.Tensor]:
        return _leaves(self.params)

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "params": self.params,
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, tree: Dict[str, Any]) -> None:
        with torch.no_grad():
            for p, t in zip(self.leaves(), _leaves(tree["params"])):
                p.copy_(t)
        self.optimizer.load_state_dict(tree["optimizer"])
        self.step = int(tree["step"])


class DPJob:
    """One training job: model/optimizer/pipeline, expressed as *gradient
    stages* over a stage-keyed parameter dict.

    ``init_params() -> {stage_name: subtree}`` (nested dicts of tensors
    on the job's device) with stage names in ascending (sorted) order
    matching ``stage_losses``. Each ``loss_fn(params, batch_shard,
    generator) -> scalar tensor`` is differentiated w.r.t. ITS stage's
    subtree only, so stages must be gradient-disjoint (a single-stage
    job — the general case — just puts everything under one name).
    Staging is what buys backward/comms overlap; correctness never
    depends on it. ``optimizer`` is a factory called on the flat list of
    parameter leaves, such as :func:`~tosem_tpu_torch.train.trainer.
    adamw`.

    ``batch_fn(step) -> global batch`` (a dict of tensors) must be
    deterministic in ``step`` — that plus the per-(step, shard) generator
    is what makes the loss trajectory a pure function of (job, grain).
    """

    def __init__(self, *, init_params: Callable[[], Dict[str, Any]],
                 stage_losses: Sequence[Tuple[str, Callable]],
                 batch_fn: Callable[[int], Any],
                 optimizer: Callable[[List[torch.Tensor]],
                                     torch.optim.Optimizer],
                 grain: int,
                 global_batch: int,
                 seed: int = 0,
                 mixed_precision: bool = False):
        names = [n for n, _ in stage_losses]
        if names != sorted(names):
            raise ValueError("stage names must be in ascending sorted "
                             f"order (dict leaf order), got {names}")
        if global_batch % grain:
            raise ValueError(f"global_batch {global_batch} not divisible "
                             f"by grain {grain}")
        self.stage_names = names
        self._stage_losses = dict(stage_losses)
        self.batch_fn = batch_fn
        self.optimizer = optimizer
        self.grain = int(grain)
        self.global_batch = int(global_batch)
        self.seed = int(seed)
        self.mixed_precision = bool(mixed_precision)
        self.init_params = init_params
        self.device: Optional[torch.device] = None
        self._stage_grad: Dict[str, Callable] = {}
        self._batch_cache: Tuple[int, Any] = (-1, None)

    # -- state ---------------------------------------------------------

    def init_state(self) -> DPState:
        params = self.init_params()
        if sorted(params) != self.stage_names:
            raise ValueError(f"init_params keys {sorted(params)} != "
                             f"stage names {self.stage_names}")
        # owned leaf tensors: a state never aliases another's buffers
        params = _tree_map(lambda x: x.detach().clone(), params)
        leaves = _leaves(params)
        self.device = leaves[0].device
        return DPState(0, params, self.optimizer(leaves))

    def grad_template(self, params: Dict[str, Any]
                      ) -> List[Tuple[int, int]]:
        """→ leaf_meta [(nbytes, stage)] of the gradient tree (== the
        params tree, stage-keyed dict in sorted order)."""
        return [(leaf.numel() * leaf.element_size(), si)
                for si, name in enumerate(self.stage_names)
                for leaf in _leaves(params[name])]

    # -- per-shard pipeline --------------------------------------------

    def batch_shard(self, step: int, shard: int):
        """The shard's slice of the deterministic global batch. The
        global batch is built once per step and sliced per shard (views,
        no copy)."""
        cs, cb = self._batch_cache
        if cs != step:
            cb = self.batch_fn(step)
            self._batch_cache = (step, cb)
        per = self.global_batch // self.grain
        lo = shard * per

        def cut(x):
            return x[lo:lo + per] if getattr(x, "ndim", 0) >= 1 else x
        return _tree_map(cut, cb)

    def shard_rng(self, step: int, shard: int) -> torch.Generator:
        """The generator of (step, shard), on the job's device."""
        if self.device is None:
            raise RuntimeError("init_state() places the job on a device "
                               "first")
        return torch.Generator(device=self.device).manual_seed(
            fold_in(fold_in(self.seed, step), shard))

    def stage_grad(self, name: str) -> Callable:
        """``(params, batch_shard, generator) -> (loss, grad leaves)`` for
        one stage — gradient w.r.t. the stage's own subtree, with fp32
        master params and optional bf16 compute. The leaves stay on the
        job's device."""
        fn = self._stage_grad.get(name)
        if fn is not None:
            return fn
        loss_fn = self._stage_losses[name]
        mp = self.mixed_precision

        def f(params, batch, generator):
            own = [x.detach().requires_grad_(True)
                   for x in _leaves(params[name])]
            p = dict(params)
            p[name] = _unflatten(params[name], own)
            with torch.enable_grad():
                if mp:
                    p = _to_bf16(p)     # bf16 compute off the fp32 master
                loss = loss_fn(p, batch, generator)
                grads = torch.autograd.grad(loss, own, allow_unused=True)
            # a leaf the loss never reached gets a zero gradient, as
            # under jax.grad
            return loss.detach(), [torch.zeros_like(x) if g is None else g
                                   for g, x in zip(grads, own)]
        self._stage_grad[name] = f
        return f

    def apply(self, state: DPState, summed_grads: Sequence[torch.Tensor]
              ) -> DPState:
        """Optimizer update from SUMMED (not yet averaged) gradient
        leaves (host tensors, leaf order), in place: each is moved to its
        parameter's device and divided by ``grain`` there, the same
        division for every arm."""
        leaves = state.leaves()
        for p, g in zip(leaves, summed_grads):
            p.grad = g.to(p.device) / self.grain
        state.optimizer.step()
        for p in leaves:
            p.grad = None
        state.step += 1
        return state

    # -- canonical shard gradients -------------------------------------

    def shard_grads(self, state: DPState, step: int, shard: int
                    ) -> Tuple[np.floating, List[torch.Tensor]]:
        """One logical shard's (loss, grad leaves) — loss left-folded
        over stages in stage order, leaves in grad-tree order, copied to
        the host. Stages write disjoint leaves, so assembly involves no
        float adds."""
        batch = self.batch_shard(step, shard)
        rng = self.shard_rng(step, shard)
        loss_acc: Optional[np.floating] = None
        leaves: List[torch.Tensor] = []
        for name in self.stage_names:
            loss, grads = self.stage_grad(name)(state.params, batch, rng)
            l32 = np.float32(loss.item())
            loss_acc = l32 if loss_acc is None else np.float32(
                np.add(loss_acc, l32))
            leaves.extend(g.to("cpu") for g in grads)
        return loss_acc, leaves


def dp_params_from_numpy(tree: Dict[str, Any], device="cuda",
                         stages: Optional[Dict[str, Callable]] = None
                         ) -> Dict[str, Any]:
    """A reference ``DPJob``'s stage-keyed parameters (nested dicts of
    numpy arrays, e.g. ``jax.tree_util.tree_map(np.asarray,
    state["params"])``) as this package's parameter dict on ``device``.
    ``stages`` maps a stage name to its own converter (a BERT stage:
    :func:`tosem_tpu_torch.models.convert.bert_params_from_numpy`);
    other leaves convert one to one, bf16 by its bits."""
    from tosem_tpu_torch.models.convert import array_to_tensor
    from tosem_tpu_torch.ops.common import resolve_device
    dev = resolve_device(device)
    out = {}
    for name, sub in tree.items():
        conv = (stages or {}).get(name)
        t = conv(sub) if conv is not None else _tree_map(array_to_tensor,
                                                         sub)
        out[name] = _tree_map(lambda x: x.to(dev), t)
    return out


# -------------------------------------------------------- chain reducer


class ChainReducer:
    """Transport lowering of the strict left fold: the running partial
    for each bucket enters at rank 0, each rank folds its own shards'
    gradients one shard at a time (ascending), and the last rank — the
    holder of the complete fold — streams the result back to everyone.
    The float grouping is ``((g₀+g₁)+g₂)+…`` regardless of how many
    workers the shards are spread over, which is the whole bit-identity
    argument. Byte-exact in flight: host tensors ride
    :func:`tosem_tpu_torch.cluster.transport.send_tensors` raw-bytes
    streams into the receiver's shm segment, mapped in place on
    arrival."""

    def __init__(self, capacity: int = 32 << 20,
                 chunk_bytes: int = 1 << 18,
                 pace_bps: Optional[float] = None):
        self.receiver = TensorReceiver(store_capacity=capacity)
        self.chunk_bytes = int(chunk_bytes)
        self.pace_bps = pace_bps
        self.rank = 0
        self.addrs: List[str] = [self.receiver.address]
        self.gen = 0
        self._aborted = False

    @property
    def address(self) -> str:
        return self.receiver.address

    def configure(self, rank: int, addrs: Sequence[str], gen: int) -> None:
        self.rank, self.addrs, self.gen = int(rank), list(addrs), int(gen)
        self._aborted = False          # a rewire re-arms the chain
        # drain streams parked by an aborted generation — their keys can
        # never be popped again and would pin receive-segment pages
        for k in self.receiver.stats()["pending_keys"]:
            try:
                self.receiver.pop(k, timeout=0.05).release()
            except (TimeoutError, TransportError):
                pass

    def abort(self) -> None:
        """Fail the chain NOW (a peer died): every blocked pop wakes
        with :class:`TransportError`, and reduces entered before the
        next :meth:`configure` fail fast instead of waiting out their
        timeout on streams a dead peer can never send. Sticky until
        the rewire, so late-arriving reduce calls of the broken
        generation cannot hang either."""
        self._aborted = True
        self.receiver.interrupt()

    def _pop(self, key: str, timeout: float):
        """pop() that also honors a sticky abort: the interrupt wakes
        waits that are already blocked, the 1 s re-check closes the
        race where abort() lands between reduce() entry and the pop."""
        deadline = time.monotonic() + timeout
        while True:
            if self._aborted:
                raise TransportError("reduce chain aborted (peer death)")
            step = min(1.0, deadline - time.monotonic())
            if step <= 0:
                raise TimeoutError(f"stream {key!r} never arrived")
            try:
                return self.receiver.pop(key, timeout=step)
            except TimeoutError:
                continue

    def reduce(self, tag: str,
               shard_arrays: Sequence[Dict[str, torch.Tensor]],
               timeout: float = 120.0
               ) -> Tuple[Dict[str, torch.Tensor], Callable[[], None], int]:
        """Fold ``shard_arrays`` (this worker's shards, ascending; host
        tensors) into the chain → (final tensors, release_cb, payload
        bytes sent). The final tensors may be views over the receive
        segment; call ``release_cb`` once they are consumed."""
        world = len(self.addrs)
        if self._aborted:
            raise TransportError("reduce chain aborted (peer death)")
        acc: Optional[Dict[str, torch.Tensor]] = None
        rx = None
        if self.rank > 0:
            rx = self._pop(f"p:{tag}", timeout)
            acc = rx.arrays()
        for g in shard_arrays:
            acc = _fold(acc, g)
        if rx is not None:
            rx.release()            # folded past the mapped partial
        if acc is None:
            raise ValueError("reduce with no local shards and no "
                             "predecessor partial")
        sent = 0
        if world == 1:
            return acc, (lambda: None), 0
        if self.rank < world - 1:
            sent += send_tensors(self.addrs[self.rank + 1],
                                 {"key": f"p:{tag}"}, acc,
                                 chunk_bytes=self.chunk_bytes,
                                 pace_bps=self.pace_bps)
            fin = self._pop(f"f:{tag}", timeout)
            return fin.arrays(), fin.release, sent
        for i, addr in enumerate(self.addrs):
            if i != self.rank:
                sent += send_tensors(addr, {"key": f"f:{tag}"}, acc,
                                     chunk_bytes=self.chunk_bytes,
                                     pace_bps=self.pace_bps)
        return acc, (lambda: None), sent

    def close(self) -> None:
        self.receiver.shutdown()


# ------------------------------------------------------- state streams
#
# A state_dict travels as its tensors (host copies, names s0, s1, ...)
# beside a JSON skeleton of everything else in the stream's metadata.


def _pack(obj: Any, out: Dict[str, torch.Tensor]) -> Any:
    if torch.is_tensor(obj):
        name = f"s{len(out)}"
        out[name] = obj.detach().to("cpu")     # explicit host copy
        return {"t": name}
    if isinstance(obj, dict):
        return {"d": [[_pack(k, out), _pack(v, out)]
                      for k, v in obj.items()]}
    if isinstance(obj, (list, tuple)):
        return {"l" if isinstance(obj, list) else "u":
                [_pack(v, out) for v in obj]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"v": obj}
    raise TypeError(f"cannot stream a {type(obj).__name__} in a state")


def _unpack(skel: Any, arrays: Dict[str, torch.Tensor]) -> Any:
    if "t" in skel:
        return arrays[skel["t"]].clone()       # owned: the pages recycle
    if "d" in skel:
        return {_unpack(k, arrays): _unpack(v, arrays)
                for k, v in skel["d"]}
    if "l" in skel:
        return [_unpack(v, arrays) for v in skel["l"]]
    if "u" in skel:
        return tuple(_unpack(v, arrays) for v in skel["u"])
    return skel["v"]


# ------------------------------------------------------- worker backend


def resolve_job(ref: str, kwargs: Optional[Dict[str, Any]]) -> DPJob:
    """``"module:qualname"`` → the factory's DPJob."""
    mod_name, _, qual = ref.partition(":")
    if not mod_name or not qual:
        raise ValueError(f"job ref {ref!r} is not 'module:qualname'")
    obj = importlib.import_module(mod_name)
    for part in qual.split("."):
        obj = getattr(obj, part)
    job = obj(**(kwargs or {}))
    if not isinstance(job, DPJob):
        raise TypeError(f"job ref {ref!r} did not build a DPJob")
    return job


class TrainWorkerBackend:
    """One data-parallel rank, hosted in-process (the threads backend).
    Its methods are the control surface the trainer calls; tiny control
    messages only — gradients and parameters stream worker→worker over
    the transport."""

    def __init__(self, job_ref: str = "", job_kwargs: Optional[dict] = None,
                 cfg: Optional[dict] = None, job: Optional[DPJob] = None):
        self.cfg = (cfg if isinstance(cfg, DataParallelConfig)
                    else DataParallelConfig.from_dict(cfg))
        self.job = job if job is not None else resolve_job(job_ref,
                                                           job_kwargs)
        if self.job.grain != self.cfg.grain:
            raise ValueError(f"job grain {self.job.grain} != cfg grain "
                             f"{self.cfg.grain}")
        self.reducer = ChainReducer(capacity=self.cfg.transport_capacity,
                                    chunk_bytes=self.cfg.chunk_bytes,
                                    pace_bps=self.cfg.wire_bps)
        self._state: Optional[DPState] = None
        self._history: List[float] = []
        self._shards: List[int] = []
        self._gen = -1
        self._rank = 0
        self._world = 1
        self._buckets: List[Bucket] = []
        self._leaf_meta: List[Tuple[int, int]] = []
        self._saver = None
        self._step_lock = threading.Lock()
        # deterministic gray-slow simulation (chaos slow_node / tests):
        # slept and reported on top of the measured compute of each step
        self._debug_slow_s = 0.0
        # (stage, shard) gradients this rank computed, aborted steps
        # included: what its kernels' launch counts are read against
        self._shard_grads = 0
        # [step, shard, loss] of every shard this rank computed: what a
        # fold that parts from another arm is traced back through
        self._shard_losses: List[List[Any]] = []
        # the clock that measures the compute region (the watchdog's
        # evidence); tests freeze it so eviction rests on reports alone
        self.clock: Callable[[], float] = time.perf_counter

    # -- control plane -------------------------------------------------

    def transport_address(self) -> str:
        return self.reducer.address

    def configure(self, rank: int, world: int, addrs: Sequence[str],
                  shards: Sequence[int], gen: int,
                  ckpt_dir: Optional[str] = None,
                  resume: bool = True) -> Dict[str, Any]:
        """(Re)wire this rank into the chain: its position, the chain
        addresses, and its contiguous logical-shard run. First call
        initializes (or checkpoint-restores) the replicated state."""
        shards = [int(s) for s in shards]
        if shards != sorted(shards):
            raise ValueError("shard run must be ascending")
        with self._step_lock:
            if self._state is None:
                state = self.job.init_state()
                if ckpt_dir and resume:
                    from tosem_tpu_torch.train import checkpoint as _ckpt
                    found = _ckpt.restore_latest(ckpt_dir, state)
                    if found is not None:
                        _, state, extra = found
                        self._history = [float(v) for v in
                                         (extra or {}).get("history", [])]
                self._state = state
                self._leaf_meta = self.job.grad_template(state.params)
                self._buckets = partition_buckets(self._leaf_meta,
                                                  self.cfg.bucket_bytes)
            self._rank, self._world = int(rank), int(world)
            self._shards = shards
            self._gen = int(gen)
            self.reducer.configure(rank, addrs, gen)
        return {"step": self._state.step, "buckets": len(self._buckets)}

    def abort_step(self) -> None:
        """Fail any in-flight reduce immediately (the trainer saw a peer
        die). Lock-free on purpose: the step holds ``_step_lock``, and
        this is exactly the call that unwedges it."""
        self.reducer.abort()

    def set_debug_slow(self, seconds: float) -> None:
        """Make this rank gray-slow: every subsequent step sleeps
        ``seconds`` and reports them as backward time. The chaos
        ``train.dist_step``/``slow_node`` fault and the watchdog tests
        drive this — a slow rank that still answers every call, the
        failure mode a liveness probe can never see."""
        self._debug_slow_s = float(seconds)

    def last_step(self) -> int:
        return self._state.step if self._state is not None else 0

    def get_history(self) -> List[float]:
        return list(self._history)

    def set_history(self, history: Sequence[float]) -> None:
        self._history = [float(v) for v in history]

    # -- the step ------------------------------------------------------

    def run_step(self, step: int, gen: int,
                 overlap: Optional[bool] = None) -> Dict[str, Any]:
        step = int(step)
        with self._step_lock:
            if self._state is None:
                raise RuntimeError("worker not configured")
            cur = self._state.step
            if step < cur:
                # idempotent replay: this rank already applied the step
                # (it finished before a peer died mid-broadcast)
                return {"step": cur, "loss": self._history[step],
                        "replayed": True, "reduce": {}}
            if step != cur:
                raise RuntimeError(f"worker at step {cur}, asked to run "
                                   f"{step}")
            if int(gen) != self._gen:
                raise RuntimeError(f"stale generation {gen} (current "
                                   f"{self._gen})")
            return self._run_step_locked(step, overlap)

    def _run_step_locked(self, step: int,
                         overlap: Optional[bool]) -> Dict[str, Any]:
        ov = self.cfg.overlap if overlap is None else bool(overlap)
        job, buckets = self.job, self._buckets
        stage_buckets: Dict[int, List[Bucket]] = {}
        for b in buckets:
            stage_buckets.setdefault(b.stage, []).append(b)
        loss_bucket = buckets[-1]
        nsh = len(self._shards)
        # per (bucket, local shard) named host tensors, filled stage by
        # stage; a bucket launches the moment its stage's backward is
        # done for every local shard
        per_bucket: Dict[int, List[Dict[str, torch.Tensor]]] = {
            b.bid: [dict() for _ in range(nsh)] for b in buckets}
        shard_loss: List[Optional[np.floating]] = [None] * nsh
        results: Dict[int, Tuple[Dict[str, torch.Tensor],
                                 Callable[[], None], int, float]] = {}
        errors: List[BaseException] = []
        threads: List[threading.Thread] = []
        serialized: List[Bucket] = []

        def do_reduce(bucket: Bucket) -> None:
            try:
                t0 = time.perf_counter()
                arrays, release, sent = self.reducer.reduce(
                    f"{self._gen}:{step}:{bucket.bid}",
                    per_bucket[bucket.bid],
                    timeout=self.cfg.reduce_timeout)
                results[bucket.bid] = (arrays, release, sent,
                                       (time.perf_counter() - t0) * 1e3)
            except BaseException as e:   # surfaced after the joins
                errors.append(e)

        # backward, stage by stage over this rank's shards; each stage
        # produces a contiguous leaf range → scatter into buckets. The
        # compute region covers the LOCAL work only (forward, backward,
        # the host copies; reduce waits are fleet-synchronized and would
        # mask the straggler) — the watchdog's per-rank signal
        if self._debug_slow_s > 0:
            time.sleep(self._debug_slow_s)
        t_bw = self.clock()
        stage_lo = 0
        for si, name in enumerate(job.stage_names):
            fn = job.stage_grad(name)
            n_leaves = 0
            for j, shard in enumerate(self._shards):
                loss, grads = fn(self._state.params,
                                 job.batch_shard(step, shard),
                                 job.shard_rng(step, shard))
                self._shard_grads += 1
                leaves = [g.to("cpu") for g in grads]   # explicit copy
                n_leaves = len(leaves)
                l32 = np.float32(loss.item())
                shard_loss[j] = (l32 if shard_loss[j] is None
                                 else np.float32(np.add(shard_loss[j],
                                                        l32)))
                for b in stage_buckets.get(si, ()):
                    d = per_bucket[b.bid][j]
                    for li in b.leaves:
                        d[f"l{li}"] = leaves[li - stage_lo]
            stage_lo += n_leaves
            for b in stage_buckets.get(si, ()):
                if b.bid == loss_bucket.bid:
                    for j in range(nsh):
                        per_bucket[b.bid][j][_LOSS_KEY] = torch.tensor(
                            [float(shard_loss[j])], dtype=torch.float32)
                if ov:
                    t = threading.Thread(target=do_reduce, args=(b,),
                                         daemon=True,
                                         name=f"tosem-allreduce-b{b.bid}")
                    t.start()
                    threads.append(t)
                else:
                    serialized.append(b)
        compute_ms = ((self.clock() - t_bw) * 1e3
                      + self._debug_slow_s * 1e3)
        for b in serialized:        # baseline arm: comms after backward,
            do_reduce(b)            # one blocked bucket at a time
        for t in threads:
            t.join()
        if errors:
            # a broken chain (peer death) aborts the step: release any
            # buckets that DID commit so their receive pages recycle
            for arrays, release, _, _ in results.values():
                release()
            raise errors[0]

        # assemble the summed grads + apply (/grain on the device)
        flat: List[Optional[torch.Tensor]] = [None] * len(self._leaf_meta)
        reduce_stats: Dict[str, Dict[str, float]] = {}
        t_ap = time.perf_counter()
        try:
            for b in buckets:
                arrays, _, sent, ms = results[b.bid]
                for li in b.leaves:
                    flat[li] = arrays[f"l{li}"]
                reduce_stats[f"b{b.bid}"] = {"bytes": float(sent),
                                             "ms": round(ms, 3)}
            total_loss = np.float32(
                results[loss_bucket.bid][0][_LOSS_KEY][0].item())
            self._state = job.apply(self._state, flat)
        finally:
            for arrays, release, _, _ in results.values():
                release()
        mean = _mean_loss(total_loss, job.grain)
        self._shard_losses.extend([step, shard, float(shard_loss[j])]
                                  for j, shard in enumerate(self._shards))
        self._history.append(mean)
        return {"step": step + 1, "loss": mean, "reduce": reduce_stats,
                "compute_ms": round(compute_ms, 3),
                "apply_ms": round((time.perf_counter() - t_ap) * 1e3, 3)}

    # -- parameter traffic (elastic catch-up / grow / state fetch) -----

    @staticmethod
    def state_from_stream(rx: Any, template: DPState) -> DPState:
        """Load a received state stream into ``template`` (the inverse
        of :meth:`send_params`): owned copies, so the mapped receive
        pages can recycle after ``release``."""
        tree = _unpack(json.loads(rx.meta["state"]), rx.arrays())
        template.load_state_dict(tree)
        return template

    def send_params(self, address: str, key: str) -> int:
        """Stream the full replicated state (params + optimizer state +
        step) to a peer's transport receiver — the grow/catch-up path;
        the trainer brokers addresses only, bytes go worker→worker."""
        arrays: Dict[str, torch.Tensor] = {}
        skel = _pack(self._state.state_dict(), arrays)
        return send_tensors(address, {"key": str(key),
                                      "step": self.last_step(),
                                      "state": json.dumps(skel)},
                            arrays, chunk_bytes=self.cfg.chunk_bytes)

    def recv_params(self, key: str, timeout: float = 60.0) -> int:
        """Adopt a peer's streamed state (byte-identical leaves)."""
        rx = self.reducer.receiver.pop(str(key), timeout=timeout)
        try:
            template = (self._state if self._state is not None
                        else self.job.init_state())
            new_state = self.state_from_stream(rx, template)
            with self._step_lock:
                self._state = new_state
        finally:
            rx.release()
        return self.last_step()

    # -- checkpointing -------------------------------------------------

    def save_checkpoint(self, root: str, history: Sequence[float],
                        keep: int = 3, async_save: bool = True) -> int:
        from tosem_tpu_torch.train import checkpoint as _ckpt
        step = self.last_step()
        extra = {"history": [float(v) for v in history]}
        if async_save:
            if self._saver is None:
                self._saver = _ckpt.AsyncCheckpointer(root, keep=keep)
            self._saver.save(step, self._state, extra=extra)
        else:
            _ckpt.save_versioned(root, step, self._state, extra=extra,
                                 keep=keep)
        return step

    def flush_checkpoints(self) -> None:
        if self._saver is not None:
            self._saver.flush()

    def stats(self) -> Dict[str, Any]:
        """The rank's place, and what it computed: ``shard_grads`` and
        the kernels' launch counts of its process (one process a rank on
        the nodes backend; on the threads backend every rank reports
        the trainer process's counts), each shard's loss as
        ``[step, shard, loss]``, and the process's rounding settings
        (:func:`~tosem_tpu_torch.ops.common.matmul_settings`)."""
        from tosem_tpu_torch.ops import registry
        from tosem_tpu_torch.ops.common import matmul_settings
        return {"rank": self._rank, "world": self._world,
                "shards": list(self._shards), "step": self.last_step(),
                "buckets": len(self._buckets), "gen": self._gen,
                "shard_grads": self._shard_grads,
                "shard_losses": [list(r) for r in self._shard_losses],
                "matmul_settings": matmul_settings(),
                "launch_counts": dict(registry.LAUNCH_COUNTS)}

    def close(self) -> None:
        self.flush_checkpoints()
        self.reducer.close()


# ----------------------------------------------------- single-process arm


def make_dp_train_step(job: DPJob, reduce: str = "local",
                       mesh: Any = None, dp_axis: str = "dp"):
    """The SAME dp step as the cluster loop, lowered for one process:
    ``step_fn(state) -> (state, {"loss": float})``, updating the
    :class:`DPState` in place (``batch``/``rng`` arguments, as
    :func:`~tosem_tpu_torch.train.trainer.fit` passes them, are
    superseded by the job's own deterministic pipeline).

    - ``reduce="local"``: sequential shards + the canonical left fold —
      BIT-identical to the transport arm at any world size (the
      reference the tests pin against).
    - ``reduce="shard_map"``: the on-device collective arm. Each
      position of ``mesh``'s ``dp_axis`` (its size must equal ``grain``)
      computes its shard's loss and gradients inside a
      :func:`~tosem_tpu_torch.parallel.spmd.shard_map` body, on its block
      of the global batch, with the shard's generator; the bodies
      ``psum`` them (no collective inside an autograd graph), and
      ``job.apply`` runs once on the sum. The psum folds in shard order
      on the device, where the local arm folds host copies, so the JAX
      package holds the two arms to float parity only.
    """
    if reduce == "local":
        def step_fn(state: DPState, batch=None, rng=None):
            step = state.step
            acc: Optional[Dict[str, torch.Tensor]] = None
            loss_acc: Optional[np.floating] = None
            for shard in range(job.grain):
                loss, leaves = job.shard_grads(state, step, shard)
                acc = _fold(acc, {f"l{i}": x
                                  for i, x in enumerate(leaves)})
                loss_acc = (loss if loss_acc is None
                            else np.float32(np.add(loss_acc, loss)))
            new_state = job.apply(state, [acc[f"l{i}"]
                                          for i in range(len(acc))])
            return new_state, {"loss": _mean_loss(loss_acc, job.grain)}
        return step_fn
    if reduce != "shard_map":
        raise ValueError(f"unknown reduce lowering {reduce!r}")
    from tosem_tpu_torch.parallel.spmd import P, axis_index, psum, shard_map
    if mesh is None:
        raise ValueError("reduce='shard_map' needs a mesh")
    if mesh.shape.get(dp_axis) != job.grain:
        raise ValueError(f"mesh axis {dp_axis!r} size "
                         f"{mesh.shape.get(dp_axis)} != grain {job.grain}")

    def body(params, batch, step):
        rng = job.shard_rng(step, axis_index(dp_axis))
        total, leaves = None, []
        for name in job.stage_names:
            loss, grads = job.stage_grad(name)(params, batch, rng)
            total = loss if total is None else total + loss
            leaves.extend(grads)
        return psum((total, leaves), dp_axis)

    sharded = shard_map(body, mesh, in_specs=(P(), P(dp_axis), P()),
                        out_specs=P())

    def step_fn(state: DPState, batch=None, rng=None):
        loss, grads = sharded(state.params, job.batch_fn(state.step),
                              state.step)
        new_state = job.apply(state, grads)
        return new_state, {"loss": _mean_loss(np.float32(loss.item()),
                                              job.grain)}
    return step_fn


# ------------------------------------------------------------ demo job


def demo_job(towers: int = 4, dim: int = 32, batch: int = 32,
             grain: int = 4, seed: int = 0, lr: float = 0.1,
             depth: int = 1, mixed_precision: bool = False,
             device="cuda") -> DPJob:
    """A gradient-staged synthetic job: ``towers`` independent linear
    regressions over a shared deterministic batch — one stage (and so
    one-or-more buckets) per tower, which is what lets the overlap
    engine hide each tower's all-reduce behind the next tower's
    backward. Used by the tests; JSON-safe kwargs, so it builds from a
    job ref. Weights and batches come from CPU generators seeded through
    ``fold_in``, then move to ``device``: the same numbers on every
    device (not the reference's: its PRNG differs)."""
    from tosem_tpu_torch.ops.common import resolve_device
    dev = resolve_device(device)
    names = [f"s{i:02d}" for i in range(towers)]

    def init_params():
        out = {}
        for i, n in enumerate(names):
            g = torch.Generator().manual_seed(fold_in(seed + 1, i))
            out[n] = {"w": (torch.randn((dim, dim), generator=g)
                            * 0.05).to(dev)}
        return out

    def batch_fn(step):
        g = torch.Generator().manual_seed(fold_in(seed, step))
        x = torch.randn((batch, dim), generator=g).to(dev)
        return {"x": x, "y": torch.roll(x, 1, dims=1)}

    def make_loss(name):
        # depth re-applies w (a deep linear chain): backward FLOPs
        # scale with depth while the gradient payload stays one dim×dim
        # leaf. A bf16 weight meets fp32 inputs at fp32, as jnp promotes
        def loss_fn(params, b, generator):
            w = params[name]["w"]
            pred = b["x"]
            w = w.to(torch.promote_types(pred.dtype, w.dtype))
            for _ in range(depth):
                pred = pred @ w
            return torch.mean((pred - b["y"]) ** 2)
        return loss_fn

    return DPJob(init_params=init_params,
                 stage_losses=[(n, make_loss(n)) for n in names],
                 batch_fn=batch_fn,
                 optimizer=functools.partial(torch.optim.SGD, lr=lr),
                 grain=grain, global_batch=batch, seed=seed,
                 mixed_precision=mixed_precision)


# ---------------------------------------------------------- the trainer


_JOBS: Dict[str, "DistributedTrainer"] = {}
_JOBS_LOCK = threading.Lock()


def jobs_stats() -> Dict[str, Dict[str, Any]]:
    """Live rollup of every registered trainer — served under the
    ``/-/stats`` ingress next to the serving deployments."""
    with _JOBS_LOCK:
        items = list(_JOBS.items())
    return {name: t.stats() for name, t in items}


class _LocalHandle:
    """Threads-backend worker: the backend object in-process. ``dead``
    and ``fail_at_step`` are the deterministic stand-ins for a lost
    worker."""

    def __init__(self, backend: TrainWorkerBackend, rank: int):
        self.backend = backend
        self.birth_rank = rank
        self.node_name = f"local{rank}"
        self.dead = False
        self.fail_at_step: Optional[int] = None

    def call(self, method: str, *args, **kwargs):
        if self.dead:
            raise ConnectionError("train worker dead (simulated)")
        if (method == "run_step" and self.fail_at_step is not None
                and int(args[0]) >= self.fail_at_step):
            self.dead = True
            raise ConnectionError("train worker died mid-step (simulated)")
        return getattr(self.backend, method)(*args, **kwargs)

    def alive(self) -> bool:
        return not self.dead

    def close(self) -> None:
        try:
            self.backend.close()
        except Exception:
            pass


class _ReplicaHandle:
    """Nodes-backend worker: a replica process reached over the RPC
    plane (``backend_call`` forwarding). A fresh client per call keeps
    concurrent step dispatch / control calls trivially safe. Every
    control call carries the spawning head's fencing ``epoch`` — a
    worker re-fenced by a recovered head rejects this handle's calls
    typed (:class:`~tosem_tpu_torch.cluster.fencing.StaleEpochError`),
    so a superseded driver cannot keep steering a rank it no longer
    owns."""

    def __init__(self, node_name: str, node: Any, replica_id: str,
                 address: str, call_timeout: float = 300.0,
                 epoch: Optional[int] = None):
        self.node_name = node_name
        self.node = node
        self.replica_id = replica_id
        self.address = address
        self._call_timeout = call_timeout
        self._epoch = epoch

    def call(self, method: str, *args, **kwargs):
        from tosem_tpu_torch.cluster.rpc import RpcClient, RpcError
        if self._epoch is not None:
            kwargs.setdefault("_epoch", self._epoch)
        cli = RpcClient(self.address, call_timeout=self._call_timeout)
        try:
            return cli.call("backend_call", method, *args, **kwargs)
        except RpcError as e:
            if str(e).startswith("StaleEpochError("):
                raise StaleEpochError(str(e))
            # app-level failure: the worker is alive, the step is not
            raise RuntimeError(f"train worker {self.replica_id}: {e}")
        finally:
            cli.close()

    def alive(self) -> bool:
        from tosem_tpu_torch.cluster.rpc import RpcClient
        try:
            cli = RpcClient(self.address, timeout=2.0, call_timeout=5.0)
            try:
                return bool(cli.call("health").get("ok"))
            finally:
                cli.close()
        except Exception:
            return False

    def close(self) -> None:
        try:
            self.node.stop_replica(self.replica_id, epoch=self._epoch)
        except Exception:
            pass


def _assign_shards(grain: int, world: int) -> List[List[int]]:
    """Contiguous ascending shard runs per rank — contiguity is load-
    bearing: it keeps the chain's fold order equal to shard order."""
    base, rem = divmod(grain, world)
    out, lo = [], 0
    for r in range(world):
        n = base + (1 if r < rem else 0)
        out.append(list(range(lo, lo + n)))
        lo += n
    return out


class DistributedTrainer:
    """Data-parallel ``fit()`` over the tensor transport.

    ``backend="threads"`` runs the ranks in-process over real transport
    sockets; ``backend="nodes"`` gang-reserves slots across ``pool``'s
    agents (journaled via the pool) and spawns each rank as a replica
    process building its own job from ``job_ref`` (so a nodes job needs
    a ref and JSON-safe ``job_kwargs``). A lost worker — a dead thread or
    a dead node — shrinks the dp worker set and the run continues from
    the last committed step with a BIT-identical loss trajectory;
    :meth:`add_worker` grows it back."""

    def __init__(self, job_ref: str = "",
                 job_kwargs: Optional[Dict[str, Any]] = None,
                 cfg: Optional[DataParallelConfig] = None, *,
                 backend: str = "threads", world: int = 2,
                 pool: Any = None,
                 job: Optional[DPJob] = None,
                 ckpt_dir: Optional[str] = None,
                 checkpoint_every: int = 0, keep: int = 3,
                 async_save: bool = True, resume: bool = True,
                 registry: Any = None):
        self.cfg = cfg or DataParallelConfig()
        if not 1 <= world <= self.cfg.grain:
            raise ValueError(f"world {world} must satisfy 1 <= world <= "
                             f"grain {self.cfg.grain}")
        if backend not in ("threads", "nodes"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "nodes" and pool is None:
            raise ValueError("backend='nodes' needs a NodePool")
        if backend == "nodes" and not job_ref:
            raise ValueError("backend='nodes' builds each rank's job from "
                             "a job ref: pass job_ref, not job")
        self.backend = backend
        self.pool = pool
        self.job_ref, self.job_kwargs = job_ref, dict(job_kwargs or {})
        # the trainer's own job copy: templates for the state fetch and
        # batch metadata for throughput accounting (never steps)
        t0 = time.perf_counter()
        self.job = job if job is not None else resolve_job(job_ref,
                                                           self.job_kwargs)
        self.ckpt_dir = ckpt_dir
        self.checkpoint_every = int(checkpoint_every)
        self.keep, self.async_save, self.resume = keep, async_save, resume
        self.overlap: Optional[bool] = None     # per-run override (bench)
        self.history: List[float] = []
        self._gen = 0
        self._workers: List[Any] = []
        self._gang = None
        self._rx: Optional[TensorReceiver] = None
        self._shrinks = 0
        self._grows = 0
        self._straggler_evictions = 0
        # every failed step attempt: its step and each failed rank's
        # error, in order (a retried step recomputes its shards)
        self.step_failures: List[Dict[str, Any]] = []
        # per-handle deque of self-reported backward times (the
        # watchdog's evidence), keyed by id(handle)
        self._compute_hist: Dict[int, Any] = {}
        self._examples_per_s = 0.0
        self.last_step_outs: List[Dict[str, Any]] = []
        self._metrics = _metrics.train_metrics(registry)
        self._spawn_seq = 0
        # one dispatch pool for the whole run (grain bounds the world,
        # so growth never needs a resize)
        from concurrent.futures import ThreadPoolExecutor
        self._pool_exec = ThreadPoolExecutor(
            max_workers=self.cfg.grain,
            thread_name_prefix=f"tosem-dp-{self.cfg.job}")
        t1 = time.perf_counter()
        if backend == "threads":
            for _ in range(world):
                self._workers.append(self._spawn_local())
        else:
            self._spawn_gang(world)
        t2 = time.perf_counter()
        self._configure_all()
        # where the start-up went: the trainer's own job, the ranks'
        # spawn (each building its job), their first configure (state)
        self._startup_s = {"job": t1 - t0, "spawn": t2 - t1,
                           "configure": time.perf_counter() - t2}
        with _JOBS_LOCK:
            _JOBS[self.cfg.job] = self
        self._record("train_started", world=world, grain=self.cfg.grain,
                     backend=backend)

    # -- worker lifecycle ----------------------------------------------

    def _spawn_local(self) -> _LocalHandle:
        self._spawn_seq += 1
        # with a ref, every rank builds its OWN DPJob (private batch
        # caches); a direct job object is shared — its caches are
        # deterministic, so concurrent ranks at worst recompute a batch
        backend = TrainWorkerBackend(
            job_ref=self.job_ref, job_kwargs=self.job_kwargs,
            cfg=self.cfg.to_dict(),
            job=(None if self.job_ref else self.job))
        return _LocalHandle(backend, self._spawn_seq)

    def _spawn_gang(self, world: int) -> None:
        """Reserve ``world`` slots spread over the pool's live agents
        (all or nothing) and start one rank in each, ranks ordered by
        agent address."""
        from tosem_tpu_torch.cluster.gang import reserve_gang
        live = self.pool.live_nodes()
        self._gang = reserve_gang(list(live.values()), world,
                                  strategy="spread", timeout=60.0)
        addr_to_name = {n.address: name for name, n in live.items()}
        ranks: List[Tuple[str, Any]] = []
        for addr in sorted(self._gang.counts):
            for _ in range(self._gang.counts[addr]):
                ranks.append((addr_to_name[addr], live[addr_to_name[addr]]))
        # the ranks start at once (each builds its job before it
        # answers); the handles keep the ranks' order
        from concurrent.futures import ThreadPoolExecutor
        seqs = [self._next_seq() for _ in ranks]
        with ThreadPoolExecutor(max_workers=len(ranks)) as ex:
            futs = [ex.submit(self._spawn_replica, name, node, seq)
                    for (name, node), seq in zip(ranks, seqs)]
        started = [f.result() for f in futs if f.exception() is None]
        failed = [f.exception() for f in futs if f.exception() is not None]
        if failed:
            for h in started:
                h.close()
            self._gang.release()
            self._gang = None
            raise failed[0]
        self._workers.extend(started)

    def _next_seq(self) -> int:
        self._spawn_seq += 1
        return self._spawn_seq

    def _spawn_replica(self, node_name: str, node: Any,
                       seq: Optional[int] = None) -> _ReplicaHandle:
        seq = self._next_seq() if seq is None else seq
        rid = f"train-{self.cfg.job}-{seq}"
        init = {"job_ref": self.job_ref, "job_kwargs": self.job_kwargs,
                "cfg": self.cfg.to_dict()}
        epoch = int(getattr(self.pool, "epoch", 0) or 0) or None
        address = node.start_replica(
            rid, "tosem_tpu_torch.train.distributed:TrainWorkerBackend",
            init_kwargs=init, epoch=epoch)
        self._record("train_worker_placed", replica_id=rid,
                     node=node_name)
        return _ReplicaHandle(node_name, node, rid, address, epoch=epoch)

    def _record(self, event: str, **fields: Any) -> None:
        if self.pool is not None:
            try:
                self.pool.record_event(event, job=self.cfg.job, **fields)
            except Exception:
                pass

    def _declare_dead(self, h: Any) -> None:
        if self.backend == "nodes" and self.pool is not None:
            try:
                self.pool.detector.declare_dead(h.node_name)
            except Exception:
                pass

    # -- wiring --------------------------------------------------------

    @property
    def world(self) -> int:
        return len(self._workers)

    def _configure_all(self, start_hint: int = 0) -> int:
        """Wire every rank into the chain (at once: a first configure
        builds the rank's state). Every rank's answer is read; the first
        failure raises."""
        from concurrent.futures import wait as cf_wait
        self._gen += 1
        addrs = [h.call("transport_address") for h in self._workers]
        assign = _assign_shards(self.cfg.grain, self.world)
        futs = [self._pool_exec.submit(h.call, "configure", r, self.world,
                                       addrs, assign[r], self._gen,
                                       self.ckpt_dir, self.resume)
                for r, h in enumerate(self._workers)]
        cf_wait(futs)
        step = max([start_hint] + [int(f.result()["step"]) for f in futs])
        self._metrics["dp_size"].set(self.world, (self.cfg.job,))
        return step

    # -- elasticity ----------------------------------------------------

    def _handle_failure(self, step: int) -> int:
        """Classify failed workers, drop the dead, catch laggards up
        from the most-advanced survivor (params stream worker→worker),
        rewire the chain, and return the step to continue from."""
        dropped = 0
        while True:
            survivors = []
            for h in self._workers:
                if h.alive():
                    survivors.append(h)
                else:
                    dropped += 1
                    self._record("train_worker_lost",
                                 node=getattr(h, "node_name", "?"))
                    self._declare_dead(h)
                    h.close()
            if not survivors:
                raise TrainWorkerLost(
                    f"every train worker died at step {step}")
            self._workers = survivors
            try:
                last = [int(h.call("last_step"))
                        for h in self._workers]
                mx = max(last)
                ahead = self._workers[last.index(mx)]
                self.history = [float(v)
                                for v in ahead.call("get_history")]
                for h, ls in zip(self._workers, last):
                    if ls < mx:
                        key = f"sync:{self._gen}:{mx}:{id(h) & 0xffff}"
                        ahead.call("send_params",
                                   h.call("transport_address"), key)
                        h.call("recv_params", key)
                        h.call("set_history", self.history)
                self._configure_all()
            except (ConnectionError, TimeoutError, OSError):
                continue        # another death mid-recovery: reclassify
            if dropped:
                # an app-level step failure with every worker alive is
                # a resync, not a shrink — the dp axis didn't move
                self._shrinks += 1
                self._record("train_shrunk", step=mx, world=self.world)
            return mx

    def add_worker(self, node_name: Optional[str] = None) -> int:
        """Grow the dp worker set by one: the new rank bootstraps its
        state from rank 0 over the transport, shards rebalance, and the
        trajectory continues bit-identically. On the nodes backend the
        rank starts on ``node_name`` (default: the first live agent by
        name)."""
        if self.world >= self.cfg.grain:
            raise ValueError("world already equals grain")
        if self.backend == "threads":
            h = self._spawn_local()
        else:
            live = self.pool.live_nodes()
            if not live:
                raise TrainWorkerLost("no live node to grow onto")
            name = node_name or sorted(live)[0]
            h = self._spawn_replica(name, live[name])
        # bootstrap BEFORE joining the chain: configure (init state),
        # then adopt rank 0's replicated state byte-for-byte
        h.call("configure", 0, 1, [h.call("transport_address")], [0],
               self._gen, None, False)
        key = f"grow:{self._gen}:{self._spawn_seq}"
        self._workers[0].call("send_params", h.call("transport_address"),
                              key)
        h.call("recv_params", key)
        h.call("set_history", self.history)
        self._workers.append(h)
        step = self._configure_all()
        self._grows += 1
        self._record("train_grown", step=step, world=self.world)
        return step

    # -- the loop ------------------------------------------------------

    def _kill_victim(self) -> None:
        """Chaos ``train.dist_step``/``kill_node``: lose the highest rank
        (deterministic victim); on the nodes backend, SIGKILL the agent
        hosting it."""
        h = self._workers[-1]
        if isinstance(h, _LocalHandle):
            h.dead = True
            return
        try:
            h.node.kill()
        except Exception:
            pass
        self._declare_dead(h)

    def _slow_victim(self, delay_s: float) -> None:
        """Chaos ``train.dist_step``/``slow_node``: make the highest
        rank gray-slow — alive to every probe, ``delay_s`` slower per
        backward. The straggler watchdog is what must catch it."""
        h = self._workers[-1]
        if isinstance(h, _LocalHandle):
            h.backend.set_debug_slow(delay_s)
            return
        try:
            h.call("set_debug_slow", delay_s)
        except Exception:
            pass

    # -- straggler watchdog --------------------------------------------

    def _note_compute(self, outs: Sequence[Any]) -> None:
        """Fold each rank's self-reported backward time into its
        history, and drop histories of departed handles."""
        live = {id(h) for h in self._workers}
        for k in [k for k in self._compute_hist if k not in live]:
            del self._compute_hist[k]
        for h, o in zip(self._workers, outs):
            ms = o.get("compute_ms") if isinstance(o, dict) else None
            if ms is None:
                continue            # idempotent replay carries no timing
            self._compute_hist.setdefault(
                id(h), collections.deque(maxlen=32)).append(float(ms))

    def _find_straggler(self) -> Optional[Any]:
        """→ the worker whose median backward time exceeds the robust
        threshold (``straggler_factor`` × fleet median-of-medians, with
        the ``straggler_min_s`` absolute floor so microsecond-scale
        jitter on tiny jobs can never trip the factor), or None."""
        cfg = self.cfg
        if cfg.straggler_factor <= 0 or self.world < 2:
            return None
        meds: Dict[int, float] = {}
        for h in self._workers:
            hist = self._compute_hist.get(id(h))
            if hist is not None and len(hist) >= cfg.straggler_min_samples:
                meds[id(h)] = statistics.median(hist)
        if len(meds) < 2:
            return None
        fleet = statistics.median(meds.values())
        worst_id = max(meds, key=lambda k: meds[k])
        threshold = max(cfg.straggler_factor * fleet,
                        cfg.straggler_min_s * 1e3)
        if meds[worst_id] <= threshold:
            return None
        return next(h for h in self._workers if id(h) == worst_id)

    def _evict_straggler(self, h: Any) -> None:
        """Route a gray-slow rank through the lost-worker path: mark it
        unusable so :meth:`_handle_failure` drops it, catches the fleet
        up, and rewires — recovery on the same timescale as a real
        death instead of a ``reduce_timeout`` stall every step."""
        self._straggler_evictions += 1
        self._compute_hist.pop(id(h), None)
        self._record("train_straggler_evicted",
                     node=getattr(h, "node_name", "?"))
        if isinstance(h, _LocalHandle):
            h.dead = True
        else:
            h.close()               # a stopped replica fails alive()
            self._declare_dead(h)

    def fit(self, num_steps: int,
            on_step: Optional[Callable[[int, Dict[str, float]], None]]
            = None) -> List[float]:
        """Run to ``num_steps`` global steps (resumable: call again with
        a larger target). Returns the loss history (one float per
        step), bit-identical to the single-process reference whatever
        died along the way."""
        from concurrent.futures import FIRST_EXCEPTION
        from concurrent.futures import wait as cf_wait
        step = max((int(h.call("last_step")) for h in self._workers),
                   default=0)
        if step > len(self.history):
            # checkpoint-restored workers carry their history; adopt it
            self.history = [float(v)
                            for v in self._workers[0].call("get_history")]
        step = max(step, len(self.history)) if self.history else step
        while step < num_steps:
            act = _chaos.fire("train.dist_step", step=step,
                              job=self.cfg.job)
            if act is not None and act["action"] == "kill_node":
                self._kill_victim()
            elif act is not None and act["action"] == "slow_node":
                self._slow_victim(float(act.get("delay_s") or 0.0))
            t0 = time.perf_counter()
            futs = [self._pool_exec.submit(h.call, "run_step", step,
                                           self._gen, self.overlap)
                    for h in self._workers]
            done, not_done = cf_wait(futs, return_when=FIRST_EXCEPTION)
            if not_done and any(f.exception() is not None
                                for f in done):
                # a rank failed mid-step: survivors are blocked on
                # chain streams the dead peer can never send — abort
                # their reduces NOW instead of letting them ride out
                # reduce_timeout before recovery starts
                for h in self._workers:
                    try:
                        h.call("abort_step")
                    except Exception:
                        pass
            outs: List[Any] = []
            for f in futs:
                try:
                    outs.append(f.result())
                except BaseException as e:
                    outs.append(e)
            fails = [o for o in outs if isinstance(o, BaseException)]
            if fails:
                self.step_failures.append(
                    {"step": step, "world": len(futs),
                     "errors": [repr(e)[:500] for e in fails]})
                step = self._handle_failure(step)
                continue
            dt = time.perf_counter() - t0
            losses = {o["loss"] for o in outs}
            if len(losses) != 1:
                raise AssertionError(
                    f"replicas diverged at step {step}: {sorted(losses)} "
                    "— determinism contract broken")
            loss = outs[0]["loss"]
            if len(self.history) == step:
                self.history.append(loss)
            else:
                self.history[step] = loss
            self.last_step_outs = outs
            self._examples_per_s = self.job.global_batch / max(dt, 1e-9)
            m = self._metrics
            m["steps"].inc(1, (self.cfg.job,))
            m["examples_per_s"].set(self._examples_per_s, (self.cfg.job,))
            for o in outs:
                for bid, rs in o.get("reduce", {}).items():
                    m["allreduce_bytes"].inc(rs["bytes"],
                                             (self.cfg.job, bid))
                    m["allreduce_ms"].observe(rs["ms"],
                                              (self.cfg.job, bid))
            done = step + 1
            if on_step is not None:
                on_step(done, {"loss": loss})
            if (self.ckpt_dir and self.checkpoint_every
                    and (done % self.checkpoint_every == 0
                         or done == num_steps)):
                try:
                    self._workers[0].call(
                        "save_checkpoint", self.ckpt_dir,
                        self.history, self.keep, self.async_save)
                except (ConnectionError, TimeoutError, OSError):
                    step = self._handle_failure(done)
                    continue
            self._note_compute(outs)
            victim = self._find_straggler()
            if victim is not None:
                # the step COMMITTED (history has its loss) — evict,
                # then recover exactly like a death at `done`
                self._evict_straggler(victim)
                step = self._handle_failure(done)
                continue
            step = done
        if self.ckpt_dir:
            try:
                self._workers[0].call("flush_checkpoints")
            except (ConnectionError, TimeoutError, OSError):
                pass
        return list(self.history)

    # -- state / stats -------------------------------------------------

    def fetch_state(self) -> DPState:
        """Rank 0's replicated state: the live object when the ranks are
        threads of this process; on the nodes backend, streamed over the
        transport and loaded into the trainer's own job template (on
        the job's device)."""
        h = self._workers[0]
        if isinstance(h, _LocalHandle):
            return h.backend._state
        if self._rx is None:
            self._rx = TensorReceiver(
                store_capacity=self.cfg.transport_capacity)
        key = f"fetch:{self._gen}:{time.monotonic_ns() & 0xffffff}"
        h.call("send_params", self._rx.address, key)
        rx = self._rx.pop(key, timeout=60.0)
        try:
            return TrainWorkerBackend.state_from_stream(
                rx, self.job.init_state())
        finally:
            rx.release()

    def stats(self) -> Dict[str, Any]:
        return {"job": self.cfg.job, "backend": self.backend,
                "world": self.world, "grain": self.cfg.grain,
                "step": len(self.history),
                "examples_per_s": round(self._examples_per_s, 2),
                "shrinks": self._shrinks, "grows": self._grows,
                "straggler_evictions": self._straggler_evictions,
                "step_failures": len(self.step_failures),
                "startup_s": {k: round(v, 3)
                              for k, v in self._startup_s.items()},
                "workers": [getattr(h, "node_name", "?")
                            for h in self._workers]}

    def close(self) -> None:
        with _JOBS_LOCK:
            if _JOBS.get(self.cfg.job) is self:
                del _JOBS[self.cfg.job]
        self._pool_exec.shutdown(wait=False)
        for h in self._workers:
            h.close()
        self._workers = []
        if self._gang is not None:
            self._gang.release()
            self._gang = None
        if self._rx is not None:
            self._rx.shutdown()
            self._rx = None

    def __enter__(self) -> "DistributedTrainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def fit_distributed(job_ref: str, num_steps: int, *,
                    job_kwargs: Optional[Dict[str, Any]] = None,
                    cfg: Optional[DataParallelConfig] = None,
                    backend: str = "threads", world: int = 2,
                    pool: Any = None,
                    ckpt_dir: Optional[str] = None,
                    checkpoint_every: int = 0, keep: int = 3,
                    async_save: bool = True, resume: bool = True,
                    on_step: Optional[Callable] = None) -> List[float]:
    """One-shot convenience: build a :class:`DistributedTrainer`, fit,
    close. Returns the loss history. ``backend="nodes"`` needs
    ``pool``."""
    tr = DistributedTrainer(job_ref, job_kwargs, cfg, backend=backend,
                            world=world, pool=pool, ckpt_dir=ckpt_dir,
                            checkpoint_every=checkpoint_every, keep=keep,
                            async_save=async_save, resume=resume)
    try:
        return tr.fit(num_steps, on_step=on_step)
    finally:
        tr.close()
