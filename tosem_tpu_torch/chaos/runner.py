"""Chaos scenarios: canned workloads that run a FaultPlan to survival.

The port's copy of ``tosem_tpu/chaos/runner.py``. Each canned plan in
:data:`tosem_tpu_torch.chaos.plan.CANNED_PLANS` pairs with a workload
here of the same name. A scenario builds the workload, runs it under an
installed :class:`ChaosController`, and returns a
:class:`SurvivalReport` — did every task/request/trial finish correctly
*despite* the injected faults? The report is what the
``tosem_tpu_torch chaos`` CLI prints.

Determinism contract: the plan's injection decisions replay exactly
from ``(seed, plan)`` (event-ordinal triggers); the asserted outcomes
(all results correct, trial resumed from checkpoint) are
timing-invariant, so the same scenario is also run as a pytest case.

Every scenario takes ``(chaos, rep, device, backend_kw)``. The ones
that compute on tensors run on ``device`` (``"cuda"`` unless the caller
asks for the CPU): ``decode-chaos``, ``decode-migrate`` and
``prefix-node-kill`` through ``BertDecodeBackend``'s ``device``,
``train-cluster`` through ``demo_job(device=)``, ``train-preempt``
through its state. Their reports also count what shows where the work
ran: the kernels the in-process fault-free pass launched
(``fault_free_launches_<kernel>``, 0 on the CPU, whose plain versions
count nothing) and ``state_on_cuda``. ``backend_kw`` updates the decode
scenarios' backend keywords, the JAX package's workload sizes by
default; it is how ``chip_smoke.py`` runs ``decode-chaos`` at BERT-base
width, and the CLI never sets it. The host-only scenarios ignore both.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

from tosem_tpu_torch.chaos.injector import ChaosController
from tosem_tpu_torch.chaos.plan import CANNED_PLANS, FaultPlan


@dataclass
class SurvivalReport:
    plan: str
    seed: int
    ok: bool
    counts: Dict[str, int] = field(default_factory=dict)
    injections: List[Dict[str, Any]] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)
    elapsed_s: float = 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    def render(self) -> str:
        verdict = "SURVIVED" if self.ok else "FAILED"
        lines = [f"chaos plan {self.plan!r} (seed={self.seed}): {verdict} "
                 f"in {self.elapsed_s:.1f}s"]
        for k in sorted(self.counts):
            lines.append(f"  {k}: {self.counts[k]}")
        lines.append(f"  faults injected: {len(self.injections)}")
        for inj in self.injections:
            lines.append(f"    #{inj['seq']} {inj['site']} -> "
                         f"{inj['action']}"
                         + (f" (target={inj['target']})"
                            if inj.get("target") else ""))
        lines.extend(f"  note: {n}" for n in self.notes)
        return "\n".join(lines)


# ------------------------------------------------------------- workloads
# module-level so cloudpickle ships them to workers by reference

def _square_after(x: int, delay_s: float = 0.05) -> int:
    time.sleep(delay_s)
    return x * x


class _EchoBackend:
    def call(self, request):
        return {"echo": request}


class _SlowEchoBackend:
    """Echo with a fixed service time — queue depth (the autoscaling
    demand signal) and estimated wait (the admission signal) both
    become controllable via offered concurrency."""

    def __init__(self, delay_s: float = 0.05):
        self._delay_s = float(delay_s)

    def call(self, request):
        time.sleep(self._delay_s)
        return {"echo": request}


class _PidEchoBackend:
    """Echo stamped with the replica process's pid — the cheapest
    possible "which replica served this?" probe, so the partition-heal
    scenario can assert router de-preferencing (suspect window →
    exactly one serving pid) without any backend-side bookkeeping."""

    def call(self, request):
        return {"pid": os.getpid(), "echo": request}


class _LedgerEchoBackend:
    """Echo that applies each request id EXACTLY ONCE to a shared
    append-only ledger file, flock-serialized across the replica
    processes. This is the side-effect audit the hedging acceptance
    plan needs: a hedge loser that lands after the winner must find
    its id already applied and retire WITHOUT a second application —
    so ledger lines == unique request ids proves first-wins hedging
    duplicated nothing."""

    def __init__(self, ledger_path: str, delay_s: float = 0.0):
        self._path = ledger_path
        self._delay_s = float(delay_s)

    def call(self, request):
        import fcntl
        if self._delay_s > 0:
            time.sleep(self._delay_s)
        rid = str(request["id"])
        with open(self._path, "a+") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            f.seek(0)
            duplicate = rid in f.read().split()
            if not duplicate:
                f.write(rid + "\n")
                f.flush()
                os.fsync(f.fileno())
        return {"echo": rid, "duplicate": duplicate}


def _counting_trainable():
    """The resumable step-counting trainable (state = iteration count):
    shared with the cluster trial plane's crash-resume tests so every
    resume path exercises the same save_state/load_state contract."""
    from tosem_tpu_torch.tune.examples import counting
    return counting


def _big_payload(i: int) -> bytes:
    """Deterministic over-INLINE_THRESHOLD result: forces the store
    path, so eviction faults have something to evict."""
    return bytes([i % 251]) * 200_000


def _pool_square(x: int) -> int:
    return x * x


# the kernels a decode backend launches: B1 (prefill), B4 (a decode
# step), B5 (a prefix hit's or a session's suffix)
_DECODE_KERNELS = ("flash_fwd", "paged_decode", "paged_decode_multi")


def _fault_free_streams(backend, prompts: List[Dict[str, Any]],
                        rep: SurvivalReport,
                        tag: str = "ref") -> List[List[int]]:
    """Each prompt decoded alone on ``backend`` in this process, no serve
    data plane (so no chaos site fires): the fault-free token streams.
    The kernels it launched add to the report's
    ``fault_free_launches_<kernel>``."""
    from tosem_tpu_torch.ops.registry import LAUNCH_COUNTS
    before = dict(LAUNCH_COUNTS)
    out = []
    for i, p in enumerate(prompts):
        sid = f"{tag}{i}"
        res = backend.admit(sid, p)
        step = 0
        while not res.get("done"):
            res = backend.step_batch([sid], [step])[0]
            step += 1
        out.append(backend.result(sid)["tokens"])
        backend.release(sid)
    for k in _DECODE_KERNELS:
        key = f"fault_free_launches_{k}"
        rep.counts[key] = (rep.counts.get(key, 0) + LAUNCH_COUNTS[k]
                           - before[k])
    return out


def _decode_prompts() -> List[Dict[str, Any]]:
    """The 8 prompts ``decode-chaos`` and ``decode-migrate`` decode."""
    return [{"ids": [1 + i, 2 + i, 3 + i, 4 + i]} for i in range(8)]


# ------------------------------------------------------------- scenarios

def _scenario_runtime(chaos: ChaosController, rep: SurvivalReport,
                      device: str, backend_kw: Dict[str, Any]) -> None:
    """24 tasks on a 4-worker pool; kills/drops must all be survived by
    the retry/replay machinery, with every result still correct."""
    import tosem_tpu_torch.runtime as rt
    rt.init(num_workers=4, memory_monitor=False)
    try:
        f = rt.remote(_square_after)
        refs = [f.remote(i) for i in range(24)]
        results = rt.get(refs, timeout=120.0)
        bad = [i for i, v in enumerate(results) if v != i * i]
        rep.counts["tasks_submitted"] = 24
        rep.counts["tasks_correct"] = 24 - len(bad)
        rep.ok = not bad
        if bad:
            rep.notes.append(f"wrong results for tasks {bad}")
    finally:
        rt.shutdown()


def _scenario_serve(chaos: ChaosController, rep: SurvivalReport,
                    device: str, backend_kw: Dict[str, Any]) -> None:
    """12 requests against a 2-replica deployment with a breaker; the
    router's retry+backoff must absorb a replica crash and a slow hit."""
    import tosem_tpu_torch.runtime as rt
    from tosem_tpu_torch.serve.core import Serve
    rt.init(num_workers=2, memory_monitor=False)
    try:
        serve = Serve()
        serve.deploy("echo", _EchoBackend, num_replicas=2,
                     circuit_breaker=True)
        h = serve.get_handle("echo")
        ok = 0
        for i in range(12):
            if h.call({"i": i}, timeout=60.0) == {"echo": {"i": i}}:
                ok += 1
        rep.counts["requests"] = 12
        rep.counts["requests_ok"] = ok
        rep.ok = ok == 12
    finally:
        rt.shutdown()


def _scenario_tune(chaos: ChaosController, rep: SurvivalReport,
                   device: str, backend_kw: Dict[str, Any]) -> None:
    """2 trials × 8 iterations, checkpoint every 2: the injected crash
    must resume its trial from the last checkpoint, not restart it."""
    import tosem_tpu_torch.runtime as rt
    from tosem_tpu_torch.tune import tune as tt
    rt.init(num_workers=2, memory_monitor=False)
    try:
        analysis = tt.run(_counting_trainable(), {"x": 1.0},
                          metric="loss", mode="min", num_samples=2,
                          max_iterations=8, checkpoint_freq=2,
                          max_concurrent=2)
        done = [t for t in analysis.trials if t.status == tt.TERMINATED]
        crashed = [t for t in analysis.trials if t.failures > 0]
        rep.counts["trials"] = len(analysis.trials)
        rep.counts["trials_finished"] = len(done)
        rep.counts["trials_crashed_and_resumed"] = len(
            [t for t in crashed if t.status == tt.TERMINATED])
        full = all(t.iteration >= 8 for t in done)
        rep.ok = (len(done) == len(analysis.trials) and full)
        if not full:
            rep.notes.append("a trial finished short of max_iterations "
                             "(restarted instead of resumed?)")
    finally:
        rt.shutdown()


def _scenario_split(chaos: ChaosController, rep: SurvivalReport,
                    device: str, backend_kw: Dict[str, Any]) -> None:
    """The acceptance-criteria run: 16 tasks on 4 workers (2 killed, one
    result dropped) plus a tune trial crashed between checkpoints — one
    runtime, everything finishes correctly."""
    import tosem_tpu_torch.runtime as rt
    from tosem_tpu_torch.tune import tune as tt
    rt.init(num_workers=4, memory_monitor=False)
    try:
        f = rt.remote(_square_after)
        refs = [f.remote(i) for i in range(16)]
        analysis = tt.run(_counting_trainable(), {"x": 1.0},
                          metric="loss", mode="min", num_samples=1,
                          max_iterations=8, checkpoint_freq=2,
                          max_concurrent=1)
        results = rt.get(refs, timeout=120.0)
        bad = [i for i, v in enumerate(results) if v != i * i]
        trial = analysis.trials[0]
        rep.counts["tasks_submitted"] = 16
        rep.counts["tasks_correct"] = 16 - len(bad)
        rep.counts["trial_iterations"] = trial.iteration
        rep.counts["trial_failures"] = trial.failures
        resumed = trial.status == tt.TERMINATED and trial.iteration >= 8
        rep.ok = not bad and resumed
        if bad:
            rep.notes.append(f"wrong results for tasks {bad}")
        if not resumed:
            rep.notes.append(f"trial ended {trial.status} at iteration "
                             f"{trial.iteration}")
    finally:
        rt.shutdown()


def _scenario_evict_heal(chaos: ChaosController, rep: SurvivalReport,
                         device: str, backend_kw: Dict[str, Any]) -> None:
    """4 store-sized results with 2 evicted from under their refs; every
    get() must transparently re-derive the lost objects from lineage —
    recovery, not the old typed ObjectLostError. One worker per task:
    with no queued tasks the steal path never duplicates an execution,
    so the evicted objects can ONLY come back through reconstruction."""
    import tosem_tpu_torch.runtime as rt
    runtime = rt.init(num_workers=4, memory_monitor=False)
    try:
        f = rt.remote(_big_payload)
        refs = [f.remote(i) for i in range(4)]
        results = rt.get(refs, timeout=120.0)
        bad = [i for i, v in enumerate(results) if v != _big_payload(i)]
        rep.counts["tasks_submitted"] = 4
        rep.counts["tasks_correct"] = 4 - len(bad)
        rep.counts["objects_evicted"] = len(
            chaos.injections("runtime.store"))
        rep.counts["objects_reconstructed"] = sum(
            runtime._recon_attempts.values())
        rep.ok = (not bad and rep.counts["objects_evicted"] > 0
                  and rep.counts["objects_reconstructed"] > 0)
        if bad:
            rep.notes.append(f"wrong results for tasks {bad}")
    finally:
        rt.shutdown()


def _scenario_node_kill(chaos: ChaosController, rep: SurvivalReport,
                        device: str, backend_kw: Dict[str, Any]) -> None:
    """8 tasks routed over a 2-agent pool; one agent is hard-killed the
    moment work lands on it. The failure detector + resubmit path must
    finish the whole workload on the survivor with zero errors."""
    from tosem_tpu_torch.cluster.node import RemoteNode
    from tosem_tpu_torch.cluster.supervisor import NodePool
    pool = NodePool(miss_threshold=1, probe_timeout=3.0)
    nodes = []
    try:
        for i in range(2):
            n = RemoteNode.spawn_local(num_workers=1)
            nodes.append(n)
            pool.add_node(n, name=f"n{i}")
        outs = [pool.submit(_pool_square, i) for i in range(8)]
        bad = [i for i, v in enumerate(outs) if v != i * i]
        rep.counts["tasks_submitted"] = 8
        rep.counts["tasks_correct"] = 8 - len(bad)
        rep.counts["nodes_killed"] = len(
            chaos.injections("cluster.submit"))
        rep.counts["nodes_surviving"] = len(pool.live_nodes())
        rep.ok = (not bad and rep.counts["nodes_killed"] > 0
                  and rep.counts["nodes_surviving"] >= 1)
        if bad:
            rep.notes.append(f"wrong results for tasks {bad}")
    finally:
        pool.close(close_nodes=True)


def _scenario_train_preempt(chaos: ChaosController, rep: SurvivalReport,
                            device: str,
                            backend_kw: Dict[str, Any]) -> None:
    """Training preempted between checkpoints; the resumed run must
    replay to completion with a metric history BIT-EXACT against an
    uninterrupted reference run (same seeds, same batches). The JAX
    package's problem in torch, through the port's ``fit``: ``w`` of 3
    zeros fitted to ``x @ [1, -2, 0.5]`` by mean squared error and steps
    of 0.1, ``x`` drawn from a generator seeded by the step."""
    import shutil
    import tempfile

    import torch

    from tosem_tpu_torch.train.trainer import (TrainingPreempted, TrainState,
                                               fit)
    target = torch.tensor([1.0, -2.0, 0.5], device=device)

    def init():
        model = torch.nn.Module()
        model.w = torch.nn.Parameter(torch.zeros(3, device=device))
        return TrainState(model=model, optimizer=torch.optim.SGD(
            model.parameters(), lr=0.1))

    def step_fn(state, batch, generator):
        x, y = batch
        state.optimizer.zero_grad()
        loss = torch.mean((x @ state.model.w - y) ** 2)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    def batch_fn(step):
        g = torch.Generator().manual_seed(step)
        x = torch.randn((8, 3), generator=g).to(device)
        return x, x @ target

    ckpt_dir = tempfile.mkdtemp(prefix="chaos_train_ck_")
    preempted_at = 0
    try:
        try:
            fit(init(), step_fn, batch_fn, 10, seed=7, ckpt_dir=ckpt_dir,
                checkpoint_every=2)
            rep.notes.append("chaos never preempted the run")
        except TrainingPreempted:
            preempted_at = len(chaos.injections("train.step"))
        # resume (fresh init state, same ckpt dir) — then an
        # uninterrupted reference run; both run after the plan's fault
        # window is spent
        state, resumed = fit(init(), step_fn, batch_fn, 10, seed=7,
                             ckpt_dir=ckpt_dir, checkpoint_every=2)
        _, reference = fit(init(), step_fn, batch_fn, 10, seed=7)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    rep.counts["steps_total"] = len(resumed)
    rep.counts["preempted"] = 1 if preempted_at else 0
    rep.counts["state_on_cuda"] = int(state.device.type == "cuda")
    rep.ok = (preempted_at > 0 and len(resumed) == 10
              and resumed == reference)
    if resumed != reference:
        rep.notes.append("resumed metric history diverged from the "
                         "uninterrupted reference run")


def _scenario_state_plane(chaos: ChaosController, rep: SurvivalReport,
                          device: str, backend_kw: Dict[str, Any]) -> None:
    """The acceptance run for the self-healing state plane: one live
    object evicted, one worker killed mid-task, one node agent killed —
    every result still arrives correct, zero user-visible errors."""
    import tosem_tpu_torch.runtime as rt
    from tosem_tpu_torch.cluster.node import RemoteNode
    from tosem_tpu_torch.cluster.supervisor import NodePool
    rt.init(num_workers=6, memory_monitor=False)
    pool = NodePool(miss_threshold=1, probe_timeout=3.0)
    nodes = []
    try:
        for i in range(2):
            n = RemoteNode.spawn_local(num_workers=1)
            nodes.append(n)
            pool.add_node(n, name=f"n{i}")
        f = rt.remote(_big_payload)
        refs = [f.remote(i) for i in range(6)]
        pool_outs = [pool.submit(_pool_square, i) for i in range(6)]
        results = rt.get(refs, timeout=120.0)
        bad = [i for i, v in enumerate(results) if v != _big_payload(i)]
        bad_pool = [i for i, v in enumerate(pool_outs) if v != i * i]
        rep.counts["runtime_tasks_correct"] = 6 - len(bad)
        rep.counts["pool_tasks_correct"] = 6 - len(bad_pool)
        rep.counts["objects_evicted"] = len(
            chaos.injections("runtime.store"))
        rep.counts["workers_killed"] = len(
            chaos.injections("runtime.dispatch"))
        rep.counts["nodes_killed"] = len(
            chaos.injections("cluster.submit"))
        rep.ok = (not bad and not bad_pool
                  and rep.counts["objects_evicted"] > 0
                  and rep.counts["workers_killed"] > 0
                  and rep.counts["nodes_killed"] > 0)
        if bad:
            rep.notes.append(f"wrong runtime results: {bad}")
        if bad_pool:
            rep.notes.append(f"wrong pool results: {bad_pool}")
    finally:
        pool.close(close_nodes=True)
        rt.shutdown()


def _scenario_decode(chaos: ChaosController, rep: SurvivalReport,
                     device: str, backend_kw: Dict[str, Any]) -> None:
    """The decode acceptance run: 8 sequences decode through the
    iteration-level scheduler while the plan spills KV pages out from
    under an active sequence AND crashes the (only) replica mid-decode.
    Every sequence must complete with the SAME tokens a fault-free run
    produces — greedy decode is deterministic, spill-restore is
    byte-preserving, and replica loss re-prefills from token history —
    with zero surfaced errors."""
    import tosem_tpu_torch.runtime as rt
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    from tosem_tpu_torch.serve.batching import DecodePolicy
    from tosem_tpu_torch.serve.core import Serve

    kw = dict(max_batch=4, max_len=64, page_size=16, num_pages=24,
              max_new_tokens=6, device=device, **backend_kw)
    prompts = _decode_prompts()
    # fault-free reference: the same backend driven sequentially
    # in-process (no serve data plane, so no chaos sites fire)
    ref_backend = BertDecodeBackend(**kw)
    expected = _fault_free_streams(ref_backend, prompts, rep)

    rt.init(num_workers=2, memory_monitor=False)
    try:
        serve = Serve()
        serve.deploy("decode", BertDecodeBackend, init_kwargs=kw,
                     decode_policy=DecodePolicy(max_active=4),
                     max_restarts=2, max_retries=3)
        h = serve.get_handle("decode")
        futs = [h.remote(p) for p in prompts]
        got, errors = [], 0
        for f in futs:
            try:
                got.append(f.result(timeout=300.0)["tokens"])
            except BaseException:
                got.append(None)
                errors += 1
        correct = sum(1 for g, e in zip(got, expected) if g == e)
        rep.counts["sequences"] = len(prompts)
        rep.counts["sequences_correct"] = correct
        rep.counts["errors_surfaced"] = errors
        st = serve.get_deployment("decode").stats()
        rep.counts["kv_spills"] = st.get("kv_spills", 0)
        rep.ok = errors == 0 and correct == len(prompts)
        if not rep.ok:
            rep.notes.append(f"expected {expected}, got {got}")
        serve.delete("decode")
    finally:
        rt.shutdown()


def _scenario_decode_migrate(chaos: ChaosController, rep: SurvivalReport,
                             device: str, backend_kw: Dict[str, Any]) -> None:
    """The cluster-decode acceptance run: 8 sequences decode through a
    DISAGGREGATED deployment (1 prefill + 2 decode replicas) while the
    plan live-drains a decode replica mid-stream (sequences must
    MIGRATE — continue from the current step, zero step-0 restarts
    from the drain) and then kills the prefill replica (in-flight
    admits re-admit; migrated sequences ride on). Every sequence must
    complete with the SAME tokens a fault-free run produces, with zero
    surfaced errors and at least one live migration observed."""
    import tosem_tpu_torch.runtime as rt
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    from tosem_tpu_torch.serve.batching import DecodePolicy
    from tosem_tpu_torch.serve.core import Serve

    kw = dict(max_batch=4, max_len=64, page_size=16, num_pages=24,
              max_new_tokens=8, device=device, **backend_kw)
    prompts = _decode_prompts()
    ref_backend = BertDecodeBackend(**kw)
    expected = _fault_free_streams(ref_backend, prompts, rep)

    rt.init(num_workers=3, memory_monitor=False)
    try:
        serve = Serve()
        serve.deploy("decode", BertDecodeBackend, init_kwargs=kw,
                     num_replicas=3,
                     decode_policy=DecodePolicy(max_active=4,
                                                prefill_replicas=1),
                     max_restarts=2, max_retries=3)
        h = serve.get_handle("decode")
        futs = [h.remote(p) for p in prompts]
        got, errors = [], 0
        for f in futs:
            try:
                got.append(f.result(timeout=300.0)["tokens"])
            except BaseException:
                got.append(None)
                errors += 1
        correct = sum(1 for g, e in zip(got, expected) if g == e)
        st = serve.get_deployment("decode").stats()
        inj = chaos.injections("serve.decode_step")
        rep.counts["sequences"] = len(prompts)
        rep.counts["sequences_correct"] = correct
        rep.counts["errors_surfaced"] = errors
        rep.counts["kv_migrations"] = st.get("kv_migrations", 0)
        rep.counts["drains_injected"] = len(
            [e for e in inj if e["action"] == "drain_replica"])
        rep.counts["prefill_kills_injected"] = len(
            [e for e in inj if e["action"] == "crash_prefill"])
        rep.ok = (errors == 0 and correct == len(prompts)
                  and rep.counts["kv_migrations"] > 0
                  and rep.counts["drains_injected"] > 0)
        if not rep.ok:
            rep.notes.append(f"expected {expected}, got {got}; "
                             f"stats {st}")
        serve.delete("decode")
    finally:
        rt.shutdown()


def _scenario_router(chaos: ChaosController, rep: SurvivalReport,
                     device: str, backend_kw: Dict[str, Any]) -> None:
    """The cluster-serving acceptance run: 24 requests through the
    router tier (2 router processes over 2 node agents × replica each)
    while the plan kills a router mid-traffic and then a replica node.
    Bounded error budget: ZERO client-surfaced errors — the handle
    fails over routers, the routers re-admit in-flight requests on
    survivors, and the controller re-places the dead node's replicas
    (journal-logged, same replica ids)."""
    from tosem_tpu_torch.cluster.node import RemoteNode
    from tosem_tpu_torch.cluster.supervisor import NodePool
    from tosem_tpu_torch.serve.cluster_serve import ClusterServe
    pool = NodePool(miss_threshold=1, probe_timeout=3.0)
    cs = None
    try:
        for i in range(2):
            pool.add_node(RemoteNode.spawn_local(num_workers=2),
                          name=f"n{i}")
        cs = ClusterServe(pool, num_routers=2, router_procs=True)
        dep = cs.deploy("echo", "tosem_tpu_torch.chaos.runner:_EchoBackend",
                        num_replicas=2, strategy="spread")
        h = cs.get_handle("echo")
        ok = errors = 0
        for i in range(24):
            try:
                if h.call({"i": i}) == {"echo": {"i": i}}:
                    ok += 1
            except BaseException:
                errors += 1
        inj = chaos.injections("serve.route")
        rep.counts["requests"] = 24
        rep.counts["requests_ok"] = ok
        rep.counts["errors_surfaced"] = errors
        rep.counts["routers_killed"] = len(
            [e for e in inj if e["action"] == "kill_router"])
        rep.counts["nodes_killed"] = len(
            [e for e in inj if e["action"] == "kill_node"])
        rep.counts["replicas_live"] = len(dep.replicas)
        rep.counts["nodes_surviving"] = len(pool.live_nodes())
        rep.ok = (errors == 0 and ok == 24
                  and rep.counts["routers_killed"] >= 1
                  and rep.counts["nodes_killed"] >= 1
                  and rep.counts["nodes_surviving"] >= 1
                  and rep.counts["replicas_live"] >= 1)
        if errors:
            rep.notes.append(f"{errors} requests surfaced errors "
                             "(budget is zero: handle failover + router "
                             "re-admission must absorb both kills)")
    finally:
        if cs is not None:
            cs.close()
        pool.close(close_nodes=True)


def _scenario_prefix_node_kill(chaos: ChaosController, rep: SurvivalReport,
                               device: str,
                               backend_kw: Dict[str, Any]) -> None:
    """The prefix-cache acceptance run: 18 shared-prefix requests (a
    96-token hot prefix + per-request suffixes, one multi-turn session
    among them) through the router tier while the plan SIGKILLs the
    node the prefix-aware router has been steering those admits to.
    Survival means: the fleet falls back to cold prefill on the
    survivor with ZERO client-surfaced errors and every response
    bit-identical to the fault-free run — prefix reuse is an
    optimisation, never a correctness dependency."""
    from tosem_tpu_torch.cluster.node import RemoteNode
    from tosem_tpu_torch.cluster.supervisor import NodePool
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    from tosem_tpu_torch.serve.cluster_serve import ClusterServe

    kw = dict(max_batch=4, max_len=192, page_size=16, num_pages=96,
              max_new_tokens=6, device=device, **backend_kw)
    shared = [(7 * i) % 97 + 1 for i in range(96)]
    prompts = [{"ids": shared + [5 + i, 6 + i, 7 + i]}
               for i in range(16)]
    # one session rides along: turn 2 extends turn 1's full history
    sess1 = {"ids": shared + [90, 91], "session": "chat"}

    ref_backend = BertDecodeBackend(**kw)

    def _ref(reqs, tag):
        return _fault_free_streams(
            ref_backend, [dict(r, session=None) for r in reqs], rep, tag)

    expected = _ref(prompts, "ref")
    exp_s1, = _ref([sess1], "s1_")
    # result tokens are the FULL stream (prompt + generated): turn 2
    # replays the whole history plus one new user token
    sess2 = {"ids": exp_s1 + [93], "session": "chat"}
    exp_s2, = _ref([sess2], "s2_")

    pool = NodePool(miss_threshold=1, probe_timeout=3.0)
    cs = None
    try:
        for i in range(2):
            pool.add_node(RemoteNode.spawn_local(num_workers=2),
                          name=f"n{i}")
        cs = ClusterServe(pool, num_routers=2, router_procs=True)
        cs.deploy("decode", "tosem_tpu_torch.serve.backends:BertDecodeBackend",
                  num_replicas=2, strategy="spread", init_kwargs=kw)
        h = cs.get_handle("decode")
        got, errors = [], 0
        traffic = ([(p, e) for p, e in zip(prompts[:8], expected[:8])]
                   + [(sess1, exp_s1)]
                   + [(p, e) for p, e in zip(prompts[8:], expected[8:])]
                   + [(sess2, exp_s2)])
        correct = 0
        for req, exp in traffic:
            try:
                out = h.call(req, timeout=300.0)
                got.append(out.get("tokens"))
                if out.get("tokens") == exp:
                    correct += 1
            except BaseException:
                got.append(None)
                errors += 1
        inj = chaos.injections("serve.route")
        st = cs.stats()
        rep.counts["requests"] = len(traffic)
        rep.counts["requests_correct"] = correct
        rep.counts["errors_surfaced"] = errors
        rep.counts["nodes_killed"] = len(
            [e for e in inj if e["action"] == "kill_node"])
        rep.counts["prefix_routed"] = st.get("prefix_routed", 0)
        rep.counts["nodes_surviving"] = len(pool.live_nodes())
        rep.ok = (errors == 0 and correct == len(traffic)
                  and rep.counts["nodes_killed"] >= 1
                  and rep.counts["nodes_surviving"] >= 1)
        if not rep.ok:
            rep.notes.append(
                f"expected bit-identical fault-free tokens "
                f"{[e for _, e in traffic]}, got {got}")
    finally:
        if cs is not None:
            cs.close()
        pool.close(close_nodes=True)


def _scenario_scale_kill(chaos: ChaosController, rep: SurvivalReport,
                         device: str, backend_kw: Dict[str, Any]) -> None:
    """The control-plane acceptance run: a 16-client burst over a
    1-replica SLO-admitted deployment drives the closed loop to scale
    up; the plan kills the node the controller CHOSE as the scale-up
    target, after the pick and before the replica process starts (the
    warming-replica window). Survival means: the dead node's warming
    replica is never counted toward capacity or routed to, overload in
    the capacity gap sheds TYPED (``Overloaded``) — zero untyped
    errors — and the scale-up lands on the surviving node."""
    import threading

    from tosem_tpu_torch.cluster.node import RemoteNode
    from tosem_tpu_torch.cluster.supervisor import NodePool
    from tosem_tpu_torch.control import ControlPlane, Overloaded, ScalePolicy
    from tosem_tpu_torch.control.admission import SLOConfig
    from tosem_tpu_torch.serve.cluster_serve import ClusterServe

    pool = NodePool(miss_threshold=1, probe_timeout=3.0)
    cs = None
    try:
        for i in range(2):
            pool.add_node(RemoteNode.spawn_local(num_workers=2),
                          name=f"n{i}")
        cs = ClusterServe(pool, num_routers=1, router_procs=False)
        dep = cs.deploy(
            "mux", "tosem_tpu_torch.chaos.runner:_SlowEchoBackend",
            num_replicas=1, strategy="pack",
            init_kwargs={"delay_s": 0.05},
            slo=SLOConfig(latency_budget_s=0.15, est_service_s=0.05,
                          target_inflight_per_replica=2,
                          classes={"decode": 10, "bulk": 0}))
        plane = ControlPlane(cs, default=ScalePolicy(
            min_units=1, max_units=3, target_per_unit=1.0,
            idle_ticks_before_downscale=2, max_up_per_tick=2))
        h = cs.get_handle("mux")
        h.call({"warm": 0})
        before = {r.node for r in dep.replicas}

        ok = [0]
        sheds = [0]
        untyped: List[BaseException] = []
        lock = threading.Lock()
        stop = time.perf_counter() + 2.5

        def client(i: int) -> None:
            k = 0
            while time.perf_counter() < stop:
                try:
                    h.call({"i": i, "k": k},
                           klass="decode" if i % 2 else "bulk")
                    with lock:
                        ok[0] += 1
                except Overloaded:
                    with lock:
                        sheds[0] += 1
                    time.sleep(0.02)
                except BaseException as e:
                    with lock:
                        untyped.append(e)
                k += 1

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        # let depth build, then run the control loop under load — the
        # first scale-up placement fires the plan's kill_node
        time.sleep(0.4)
        deadline = time.perf_counter() + 4.0
        while (time.perf_counter() < deadline
               and len(dep.replicas) < 2):
            plane.tick()
            time.sleep(0.1)
        for t in threads:
            t.join()

        inj = chaos.injections("control.scale")
        live = set(pool.live_nodes())
        placed_nodes = {r.node for r in dep.replicas}
        rep.counts["requests_ok"] = ok[0]
        rep.counts["sheds_typed"] = sheds[0]
        rep.counts["errors_untyped"] = len(untyped)
        rep.counts["nodes_killed"] = len(
            [e for e in inj if e["action"] == "kill_node"])
        rep.counts["replicas_live"] = len(dep.replicas)
        rep.counts["replicas_on_dead_nodes"] = len(
            [r for r in dep.replicas if r.node not in live])
        rep.counts["scaled_up"] = int(len(dep.replicas) >= 2)
        rep.ok = (not untyped
                  and rep.counts["nodes_killed"] >= 1
                  and rep.counts["replicas_on_dead_nodes"] == 0
                  and rep.counts["scaled_up"] == 1
                  and ok[0] > 0)
        if untyped:
            rep.notes.append(
                f"{len(untyped)} UNTYPED client errors (first: "
                f"{untyped[0]!r}) — overload must shed Overloaded, "
                "never route to a warming/dead replica")
        if before and placed_nodes and before & placed_nodes == set():
            rep.notes.append("original replica moved unexpectedly")
    finally:
        if cs is not None:
            cs.close()
        pool.close(close_nodes=True)


def _scenario_train_cluster(chaos: ChaosController, rep: SurvivalReport,
                            device: str, backend_kw: Dict[str, Any]) -> None:
    """The distributed-training acceptance run: a dp job (grain=4
    logical shards) gang-scheduled over 3 node agents trains while the
    plan hard-kills the node hosting the highest rank mid-epoch
    (``train.dist_step`` ordinal 3). The trainer must SHRINK the dp
    axis — rewire the reduce chain over the survivors, catch
    stragglers up worker→worker — and continue; the scenario then
    GROWS it back (rejoin bootstraps params from rank 0). The whole
    loss trajectory must be BIT-identical to single-process ``fit()``
    at equal global batch (logical shards and the left-fold reduction
    order are fixed; membership only moves shard boundaries), with
    zero surfaced errors."""
    from tosem_tpu_torch.cluster.node import RemoteNode
    from tosem_tpu_torch.cluster.supervisor import NodePool
    from tosem_tpu_torch.train.distributed import (DataParallelConfig,
                                             DistributedTrainer,
                                             demo_job, make_dp_train_step)

    jobkw = dict(towers=3, dim=16, batch=16, grain=4, seed=7, device=device)
    job = demo_job(**jobkw)
    state = job.init_state()
    rep.counts["state_on_cuda"] = int(all(
        w.device.type == "cuda" for tower in state.params.values()
        for w in tower.values()))
    step_fn = make_dp_train_step(job)
    ref = []
    for _ in range(10):
        state, m = step_fn(state)
        ref.append(m["loss"])

    pool = NodePool(miss_threshold=1, probe_timeout=3.0)
    tr = None
    errors = 0
    losses: List[float] = []
    try:
        for i in range(3):
            pool.add_node(RemoteNode.spawn_local(num_workers=1),
                          name=f"n{i}")
        cfg = DataParallelConfig(grain=4, job="train-cluster")
        tr = DistributedTrainer("tosem_tpu_torch.train.distributed:demo_job",
                                jobkw, cfg, backend="nodes", world=3,
                                pool=pool)
        try:
            tr.fit(6)          # the plan kills a node at ordinal 3
            tr.add_worker()    # rejoin: grow the dp axis back
            losses = tr.fit(10)
        except BaseException as e:
            errors += 1
            rep.notes.append(f"fit surfaced {type(e).__name__}: {e}")
        inj = chaos.injections("train.dist_step")
        st = tr.stats()
        rep.counts["steps"] = len(losses)
        rep.counts["errors_surfaced"] = errors
        rep.counts["nodes_killed"] = len(
            [e for e in inj if e["action"] == "kill_node"])
        rep.counts["shrinks"] = st["shrinks"]
        rep.counts["grows"] = st["grows"]
        rep.counts["world"] = st["world"]
        rep.counts["losses_bit_identical"] = int(losses == ref)
        rep.counts["nodes_surviving"] = len(pool.live_nodes())
        rep.ok = (errors == 0 and losses == ref
                  and rep.counts["nodes_killed"] >= 1
                  and rep.counts["shrinks"] >= 1
                  and rep.counts["grows"] >= 1)
        if losses != ref:
            rep.notes.append(f"loss trajectory diverged: ref {ref} "
                             f"got {losses}")
    finally:
        if tr is not None:
            tr.close()
        pool.close(close_nodes=True)


def _scenario_partition_heal(chaos: ChaosController, rep: SurvivalReport,
                             device: str, backend_kw: Dict[str, Any]) -> None:
    """The gray-failure detection run: the head is partitioned away
    from n1 (probes fail silently — the node itself stays healthy and
    keeps serving), held dark across four sweeps, then healed. The
    detector must move n1 ALIVE → SUSPECT (never dead: the adaptive
    detector is what buys the heal time a binary one would not), the
    router must de-prefer the suspect replica (every suspect-window
    request lands on the healthy node's pid), and after the heal the
    suspicion must clear and BOTH replicas serve again — zero surfaced
    errors end to end."""
    from tosem_tpu_torch.chaos import network as _net
    from tosem_tpu_torch.cluster.node import RemoteNode
    from tosem_tpu_torch.cluster.supervisor import NodePool
    from tosem_tpu_torch.serve.cluster_serve import ClusterServe
    # miss budget 5 so four partitioned sweeps (misses 1-4) stay in
    # SUSPECT; the plan heals at n1's sweep 6, before the probes fire
    pool = NodePool(miss_threshold=5, probe_timeout=3.0)
    cs = None
    suspect_events: List[bool] = []
    deaths: List[str] = []
    try:
        for i in range(2):
            pool.add_node(RemoteNode.spawn_local(num_workers=2),
                          name=f"n{i}")
        pool.add_suspect_listener(
            lambda name, node, entering: suspect_events.append(entering))
        pool.add_death_listener(lambda name, node: deaths.append(name))
        cs = ClusterServe(pool, num_routers=1, router_procs=False)
        cs.deploy("echo", "tosem_tpu_torch.chaos.runner:_PidEchoBackend",
                  num_replicas=2, strategy="spread")
        h = cs.get_handle("echo")
        errors = 0

        def batch(n: int) -> set:
            nonlocal errors
            pids = set()
            for i in range(n):
                try:
                    pids.add(h.call({"i": i})["pid"])
                except BaseException:
                    errors += 1
            return pids

        pool.detector.check_once()       # sweep 1: all healthy
        healthy_pids = batch(8)
        pool.detector.check_once()       # sweep 2: partition → SUSPECT
        window_pids = batch(8)           # de-preference window
        for _ in range(3):
            pool.detector.check_once()   # sweeps 3-5: misses 2..4
        still_gray = pool.detector.is_suspect("n1")
        pool.detector.check_once()       # sweep 6: heal → probe ok
        healed_pids = batch(8)

        rep.counts["requests"] = 24
        rep.counts["errors_surfaced"] = errors
        rep.counts["suspect_enters"] = sum(1 for e in suspect_events if e)
        rep.counts["suspect_clears"] = sum(
            1 for e in suspect_events if not e)
        rep.counts["deaths"] = len(deaths)
        rep.counts["replicas_serving_healthy"] = len(healthy_pids)
        rep.counts["replicas_serving_suspect_window"] = len(window_pids)
        rep.counts["replicas_serving_healed"] = len(healed_pids)
        rep.counts["partitions_injected"] = len(
            [e for e in chaos.injections("cluster.probe")
             if e["action"] == "partition"])
        rep.counts["heals_injected"] = len(
            [e for e in chaos.injections("cluster.probe")
             if e["action"] == "heal"])
        rep.ok = (errors == 0 and not deaths and still_gray
                  and rep.counts["suspect_enters"] >= 1
                  and rep.counts["suspect_clears"] >= 1
                  and not pool.detector.is_suspect("n1")
                  and len(healthy_pids) == 2
                  and len(window_pids) == 1
                  and window_pids < healthy_pids
                  and len(healed_pids) == 2
                  and rep.counts["partitions_injected"] >= 1
                  and rep.counts["heals_injected"] >= 1)
        if len(window_pids) != 1:
            rep.notes.append(
                "suspect-window traffic was not drained onto the "
                f"healthy replica (served by {len(window_pids)} pids)")
        if deaths:
            rep.notes.append(f"gray node declared dead: {deaths} — the "
                             "heal should have beaten the miss budget")
    finally:
        if cs is not None:
            cs.close()
        pool.close(close_nodes=True)
        _net.state().reset()


def _scenario_slow_node_hedge(chaos: ChaosController, rep: SurvivalReport,
                              device: str, backend_kw: Dict[str, Any]) -> None:
    """The tail-tolerance acceptance run: two deployments share a
    flock-serialized side-effect ledger; the plan turns one of the
    hedged deployment's replica nodes gray (0.3s injected wire delay —
    6× the 50ms service time) on its first request. The router's hedge
    must cap the hedged deployment's p99 within 2× the healthy-fleet
    p99 (measured on the untouched baseline deployment) and WELL under
    the injected delay, with zero surfaced errors and a ledger showing
    every request id applied exactly once (the hedge loser retires,
    never double-applies)."""
    import tempfile
    import shutil

    from tosem_tpu_torch.chaos import network as _net
    from tosem_tpu_torch.cluster.node import RemoteNode
    from tosem_tpu_torch.cluster.supervisor import NodePool
    from tosem_tpu_torch.serve.cluster_serve import ClusterServe
    from tosem_tpu_torch.serve.router import RouterPolicy

    pool = NodePool(miss_threshold=3, probe_timeout=3.0)
    cs = None
    tmp = tempfile.mkdtemp(prefix="chaos_hedge_")
    ledger = os.path.join(tmp, "ledger.txt")
    open(ledger, "w").close()
    try:
        for i in range(2):
            pool.add_node(RemoteNode.spawn_local(num_workers=2),
                          name=f"n{i}")
        cs = ClusterServe(
            pool, num_routers=1, router_procs=False,
            router_policy=RouterPolicy(hedge_after_s=0.06,
                                       hedge_quantile=0.9,
                                       hedge_min_samples=6))
        for dep in ("baseline", "hedged"):
            cs.deploy(dep, "tosem_tpu_torch.chaos.runner:_LedgerEchoBackend",
                      num_replicas=2, strategy="spread",
                      init_kwargs={"ledger_path": ledger,
                                   "delay_s": 0.05})
        errors = 0

        def run(handle, tag: str, n: int) -> List[float]:
            nonlocal errors
            lat = []
            for i in range(n):
                t0 = time.perf_counter()
                try:
                    handle.call({"id": f"{tag}-{i}"})
                except BaseException:
                    errors += 1
                lat.append(time.perf_counter() - t0)
            return lat

        def p99(lat: List[float]) -> float:
            return sorted(lat)[int(0.99 * (len(lat) - 1))]

        lat_base = run(cs.get_handle("baseline"), "base", 40)
        # first hedged request fires the plan's slow_node on the node
        # hosting the hedged deployment's last replica
        lat_hedge = run(cs.get_handle("hedged"), "hedge", 40)
        time.sleep(0.4)              # let the last hedge losers retire
        p99_healthy, p99_hedged = p99(lat_base), p99(lat_hedge)

        lines = [ln for ln in open(ledger).read().splitlines() if ln]
        stats = [r.stats() for r in cs._routers_snapshot()]
        hedged_fired = sum(s.get("hedged", 0) for s in stats)
        hedge_wins = sum(s.get("hedge_wins", 0) for s in stats)
        rep.counts["requests"] = 80
        rep.counts["errors_surfaced"] = errors
        rep.counts["p99_healthy_ms"] = int(p99_healthy * 1e3)
        rep.counts["p99_hedged_ms"] = int(p99_hedged * 1e3)
        rep.counts["hedges_fired"] = hedged_fired
        rep.counts["hedge_wins"] = hedge_wins
        rep.counts["ledger_applied"] = len(lines)
        rep.counts["ledger_duplicates"] = len(lines) - len(set(lines))
        rep.counts["slow_nodes_injected"] = len(
            chaos.injections("serve.route"))
        # the 0.18s floor absorbs CI scheduler jitter when the healthy
        # p99 itself is tiny; 0.25s keeps the bound strictly under the
        # 0.3s injected gray delay (an unhedged slow hit costs 0.35s)
        tail_ok = p99_hedged <= max(2 * p99_healthy, 0.18) \
            and p99_hedged < 0.25
        rep.ok = (errors == 0 and tail_ok
                  and hedged_fired >= 1 and hedge_wins >= 1
                  and len(lines) == 80
                  and rep.counts["ledger_duplicates"] == 0
                  and set(lines) == {f"base-{i}" for i in range(40)}
                  | {f"hedge-{i}" for i in range(40)}
                  and rep.counts["slow_nodes_injected"] >= 1)
        if not tail_ok:
            rep.notes.append(
                f"hedged p99 {p99_hedged * 1e3:.0f}ms vs healthy "
                f"{p99_healthy * 1e3:.0f}ms — hedging failed to cap "
                "the gray tail")
        if rep.counts["ledger_duplicates"]:
            rep.notes.append("hedge loser double-applied a side effect")
    finally:
        if cs is not None:
            cs.close()
        pool.close(close_nodes=True)
        _net.state().reset()
        shutil.rmtree(tmp, ignore_errors=True)


def _scenario_stale_head_fenced(chaos: ChaosController, rep: SurvivalReport,
                                device: str,
                                backend_kw: Dict[str, Any]) -> None:
    """The split-brain acceptance run: head A (journaled) is
    partitioned away from BOTH nodes — it suspects the whole fleet
    while the agents and replicas keep running — and a REPLACEMENT
    head B recovers from the journal during A's gray window, bumping
    the epoch lease and fencing every surviving agent and replica.
    After the heal, stale head A still believes it owns the cluster:
    every write it attempts — journal append, replica placement,
    replica stop, backend control call — must be rejected with a TYPED
    StaleEpochError, replica ownership must sit exclusively with B
    (adopted under the SAME ids and addresses, no duplicates), and
    clients riding B must see zero errors."""
    import shutil
    import tempfile

    from tosem_tpu_torch.chaos import network as _net
    from tosem_tpu_torch.cluster.fencing import StaleEpochError
    from tosem_tpu_torch.cluster.node import RemoteNode
    from tosem_tpu_torch.cluster.rpc import RpcClient, RpcError
    from tosem_tpu_torch.cluster.supervisor import NodePool
    from tosem_tpu_torch.serve.cluster_serve import ClusterServe

    tmp = tempfile.mkdtemp(prefix="chaos_fence_")
    jpath = os.path.join(tmp, "head.jsonl")
    # miss budget 4: three partitioned sweeps (misses 1-3) keep the
    # fleet in SUSPECT at head A — gray, never declared dead
    pool_a = NodePool(journal_path=jpath, miss_threshold=4,
                      probe_timeout=3.0)
    cs_a = cs_b = None
    try:
        for i in range(2):
            pool_a.add_node(RemoteNode.spawn_local(num_workers=2),
                            name=f"n{i}")
        cs_a = ClusterServe(pool_a, num_routers=1, router_procs=False)
        dep_a = cs_a.deploy("echo",
                            "tosem_tpu_torch.chaos.runner:_EchoBackend",
                            num_replicas=2, strategy="spread")
        old_epoch = cs_a.epoch
        owned = {r.replica_id: (r.node, r.address)
                 for r in dep_a.replicas}
        pool_a.detector.check_once()     # sweep 1: healthy
        pool_a.detector.check_once()     # sweep 2: partition both
        suspects = len(pool_a.detector.suspects())
        pool_a.detector.check_once()     # sweep 3 (miss 2)
        pool_a.detector.check_once()     # sweep 4 (miss 3 < budget)
        # replacement head: journal recovery bumps the epoch lease and
        # fences the agents + adopted replicas (recovery's own health
        # probes are direct RPC — the emulated partition only severs
        # head A's detector)
        cs_b = ClusterServe.recover(jpath, num_routers=1,
                                    router_procs=False,
                                    probe_timeout=3.0, miss_threshold=4)
        new_epoch = cs_b.epoch
        reps_b = list(cs_b._deployments["echo"].replicas)
        adopted = {r.replica_id: (r.node, r.address) for r in reps_b}

        # stale head A, still holding its clients, tries to write
        fenced = dict.fromkeys(
            ("journal", "placement", "stop", "backend"), 0)
        try:
            pool_a.record_event("stale_head_write")
        except StaleEpochError:
            fenced["journal"] = 1
        live_a = pool_a.live_nodes()
        try:
            live_a["n0"].start_replica(
                "echo#stale", "tosem_tpu_torch.chaos.runner:_EchoBackend",
                init_kwargs={}, epoch=old_epoch)
        except StaleEpochError:
            fenced["placement"] = 1
        rid0, (host0, addr0) = sorted(owned.items())[0]
        try:
            live_a[host0].stop_replica(rid0, epoch=old_epoch)
        except StaleEpochError:
            fenced["stop"] = 1
        try:
            with RpcClient(addr0) as cli:
                cli.call("backend_call", "call", {"i": "stale"},
                         _epoch=old_epoch)
        except RpcError as e:
            if str(e).startswith("StaleEpochError("):
                fenced["backend"] = 1
        pool_a.detector.check_once()     # sweep 5: heal fires
        # clients ride the NEW head; the fleet serves as before
        h_b = cs_b.get_handle("echo")
        ok = errors = 0
        for i in range(8):
            try:
                if h_b.call({"i": i}) == {"echo": {"i": i}}:
                    ok += 1
            except BaseException:
                errors += 1

        rids_b = [r.replica_id for r in reps_b]
        rep.counts["epoch_old"] = old_epoch
        rep.counts["epoch_new"] = new_epoch
        rep.counts["fleet_suspected"] = suspects
        rep.counts["stale_writes_fenced"] = sum(fenced.values())
        rep.counts["replicas_adopted"] = len(reps_b)
        rep.counts["duplicate_ownership"] = (
            len(rids_b) - len(set(rids_b))
            + sum(1 for rid in adopted if adopted[rid] != owned.get(rid)))
        rep.counts["requests_ok"] = ok
        rep.counts["errors_surfaced"] = errors
        rep.counts["partitions_injected"] = len(
            [e for e in chaos.injections("cluster.probe")
             if e["action"] == "partition"])
        rep.ok = (new_epoch > old_epoch and suspects == 2
                  and sum(fenced.values()) == 4
                  and adopted.keys() == owned.keys()
                  and rep.counts["duplicate_ownership"] == 0
                  and errors == 0 and ok == 8
                  and rep.counts["partitions_injected"] >= 2)
        for path, hit in sorted(fenced.items()):
            if not hit:
                rep.notes.append(f"stale head's {path} write was NOT "
                                 "fenced (split-brain hazard)")
        if adopted.keys() != owned.keys():
            rep.notes.append(f"recovery re-placed instead of adopting: "
                             f"owned {sorted(owned)} vs adopted "
                             f"{sorted(adopted)}")
    finally:
        if cs_b is not None:
            try:
                cs_b.close()
            except Exception:
                pass
            try:
                cs_b.pool.close(close_nodes=False)
            except Exception:
                pass
        if cs_a is not None:
            try:
                cs_a.close()     # fenced: teardown journaling may raise
            except Exception:
                pass
        pool_a.close(close_nodes=True)
        _net.state().reset()
        shutil.rmtree(tmp, ignore_errors=True)


SCENARIOS: Dict[str, Callable[..., None]] = {
    "worker-carnage": _scenario_runtime,
    "serve-flap": _scenario_serve,
    "trial-crash": _scenario_tune,
    "split-survival": _scenario_split,
    "evict-heal": _scenario_evict_heal,
    "node-kill-heal": _scenario_node_kill,
    "train-preempt": _scenario_train_preempt,
    "state-plane-survival": _scenario_state_plane,
    "decode-chaos": _scenario_decode,
    "decode-migrate": _scenario_decode_migrate,
    "router-chaos": _scenario_router,
    "train-cluster": _scenario_train_cluster,
    "scale-under-kill": _scenario_scale_kill,
    "partition-heal": _scenario_partition_heal,
    "slow-node-hedge": _scenario_slow_node_hedge,
    "prefix-node-kill": _scenario_prefix_node_kill,
    "stale-head-fenced": _scenario_stale_head_fenced,
}


def run_plan(plan: FaultPlan, scenario: str = "", device: str = "cuda",
             backend_kw: Dict[str, Any] = None) -> SurvivalReport:
    """Run ``plan`` against its scenario (by plan name unless
    ``scenario`` overrides) and return the survival report. Tensor
    workloads run on ``device``; ``backend_kw`` updates the decode
    scenarios' backend keywords (module docstring)."""
    name = scenario or plan.name
    if name not in SCENARIOS:
        raise ValueError(f"no chaos scenario {name!r}; choose from "
                         f"{sorted(SCENARIOS)}")
    rep = SurvivalReport(plan=plan.name or name, seed=plan.seed, ok=False)
    t0 = time.monotonic()
    with ChaosController(plan) as chaos:
        try:
            SCENARIOS[name](chaos, rep, device, dict(backend_kw or {}))
        finally:
            rep.injections = chaos.injections()
            rep.elapsed_s = time.monotonic() - t0
    return rep
