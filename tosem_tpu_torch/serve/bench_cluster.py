"""Cluster serving microbenchmarks — the multi-process closed-loop leg.

The first bench in the repo whose workload spans process trees: 2 node
agents × 2 replicas each behind the router tier
(:mod:`tosem_tpu_torch.serve.cluster_serve`), interleaved A/B against the
single-process serve data plane on the SAME backend (per the
bench-noise protocol: both arms of a round share the host phase; the
absolute floors are min-of-rounds).

The acceptance leg is **failover**: a 16-client closed-loop fleet runs
THROUGH a mid-run node kill — the failure detector declares the node
dead, the controller re-places its replicas on the survivor under the
same ids, and routers re-admit in-flight requests from step 0. The
deterministic criteria are hard asserts: ZERO client-surfaced errors
(no logical request lost beyond transparent retries) and full
re-placement off the dead node. Throughput recovery is scored against
a same-shape CONTROL cluster deployment measured concurrently (the
only phase control that works here — see the leg's comment for the
measurement history), hard-failed only below a catastrophic 0.5x
bound, and recorded as a gated row so the perf gate tracks recovery
(vs the 1.0 baseline, standard threshold) release over release.

A non-gated parity leg deploys a ``sharding=(1, 2)`` replica (dp×tp
mesh in its own process, gang-reserved slots) and pins its response
bit-identical to the single-process kernel on the same inputs — run by
the full bench (``cli --config=cluster_bench``), skipped under
``--only gated`` (it pays a torch import and kernel launches in a fresh
process).

A copy of the JAX package's ``serve/bench_cluster.py``. What differs:

- Every answer check raises as in the reference (zero client errors
  across the kill, full re-placement, bit-identical sharded answers,
  disaggregated ≡ colocated streams, migrations and drains that lose no
  work, hedges that fire, the control loop's typed sheds, scale-up,
  convergence and zero cold serves). The wall-clock bounds the reference
  raises on — the failover recovery ratio's catastrophic 0.5x, the
  hedged p99 under 0.8x the injected delay, the control scenario's
  steady p99 under the 0.5 s budget — were set on other hosts; no speed
  target carries over to the port (ROADMAP.md's ground rules), so each
  is reported on its row (``reference_floor`` or ``reference_ceiling``
  and ``floor_met`` in ``extra``) and the bench does not raise on it.
- The model replicas (the decode legs' ``BertDecodeBackend``, the
  sharded replicas and their references) run on ``device``, the card
  unless the caller asks for the CPU.
- The reference's ``--save``/``--check`` baseline gate is not ported.

``python -m tosem_tpu_torch.cli --config=cluster_bench`` runs
:func:`run_cluster_benchmarks` and ``--config=control_bench``
:func:`run_control_benchmarks`. The module's top level loads the
standard library only, so a replica that imports
:class:`ControlLoadBackend` by name boots without torch.
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

from tosem_tpu_torch.serve.bench_common import (SuiteEmitter, closed_loop,
                                          paired_loop)
from tosem_tpu_torch.utils.results import ResultRow

# Gated by ci.sh --perf: absolute throughput floors for both arms (min
# of rounds) plus the failover recovery ratio (phase-immune: pre and
# post rounds are adjacent in time). The cluster arm pays two RPC hops
# per request — its floor documents the cost of crossing process trees,
# it is NOT expected to beat the in-process data plane on a 2-CPU host.
GATED_CLUSTER_BENCHES = (
    "cluster_router_c16", "cluster_single_ref_c16",
    "cluster_failover_recovery",
    "cluster_decode_disagg_c16", "cluster_decode_coloc_c16",
    "cluster_decode_disagg_vs_coloc",
    "cluster_drain_migrate_vs_readmit",
    "router_hedged_p99",
)

# the hedged-tail A/B's bench ids (its own small cluster + emulated-
# network fault — kept out of the legacy router/failover block)
HEDGE_BENCH_IDS = ("router_hedged_p99", "router_unhedged_p99",
                   "router_hedge_tail_win")

# ``bench_runtime --cluster --scenario=...`` subsets (mirrors the
# decode bench's SCENARIO_BENCHES shape)
CLUSTER_SCENARIOS = {
    "decode": ("cluster_decode_disagg_c16", "cluster_decode_coloc_c16",
               "cluster_decode_disagg_vs_coloc"),
    "migrate": ("cluster_drain_migrate_vs_readmit",
                "cluster_drain_errors"),
}

# ``bench_runtime --control`` — the closed-loop diurnal/burst scenario
# (the control/ acceptance leg); the JAX package gates these rows
GATED_CONTROL_BENCHES = (
    "control_steady_p99_ms", "control_steady_sheds",
    "control_burst_scaleup", "control_replica_convergence",
    "control_cold_serves",
)

BACKEND_REF = "tosem_tpu_torch.serve.bench_serve:VectorWorkBackend"
BACKEND_KW = {"n": 256}

# cluster-decode workload: long prompts (a prefill costs several
# decode steps), page config sized so c16 plus admissions in flight
# never hit pressure. The disaggregation A/B runs MIXED traffic — 8
# decode-heavy "chat" clients + 8 prefill-only "embed" clients
# (max_new_tokens=1, the embedding/scoring class) — because that is
# the workload disaggregation exists for: on a colocated deployment
# every embed admit stalls the step loop and every embed occupies a
# step row doing nothing, starving the in-flight token streams, while
# the disaggregated arm resolves embeds ENTIRELY on the prefill tier.
# (Uniform all-chat traffic on the JAX package's 2-CPU host was
# compute-conserving: one process's intra-op threading saturated both
# cores, so no multi-process split beat one well-batched replica.)
DECODE_KW = dict(max_batch=16, max_len=512, page_size=16,
                 num_pages=768, max_new_tokens=32, dim=32, heads=2,
                 layers=2, mlp_dim=64)
DECODE_PROMPT_LEN = 480


def _fleet_with_errors(handle, n_clients: int, duration_s: float):
    """Closed-loop fleet that RECORDS failures instead of aborting —
    the failover window's client view. Returns (completed, errors)."""
    stop = time.perf_counter() + duration_s
    done = [0] * n_clients
    errors: List[BaseException] = []
    lock = threading.Lock()

    def client(i):
        while time.perf_counter() < stop:
            try:
                handle.call({"x": i}, timeout=120.0)
                done[i] += 1
            except BaseException as e:
                with lock:
                    errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return sum(done), errors


def run_cluster_benchmarks(trials: int = 3, min_s: float = 0.5,
                           quiet: bool = False,
                           only: Optional[set] = None,
                           device="cuda") -> List[ResultRow]:
    """Interleaved A/B cluster benches; ``only`` restricts bench_ids.
    Router/failover/parity legs spawn the node-agent cluster; the
    cluster-decode legs (disaggregated prefill/decode A/B, drain-with-
    migration A/B) ride the actor-replica decode plane — each block
    only runs when a bench id it owns is wanted. ``device`` is where
    the model replicas run."""
    import tosem_tpu_torch.runtime as rt

    em = SuiteEmitter("cluster", only)
    decode_ids = (set(CLUSTER_SCENARIOS["decode"])
                  | set(CLUSTER_SCENARIOS["migrate"]))
    hedge_ids = set(HEDGE_BENCH_IDS)
    legacy_wanted = only is None or bool(
        set(only) - decode_ids - hedge_ids)
    decode_wanted = only is None or bool(set(only) & decode_ids)
    hedge_wanted = only is None or bool(set(only) & hedge_ids)

    own_runtime = not rt.is_initialized()
    if own_runtime:
        rt.init(num_workers=2, memory_monitor=False)
    try:
        if legacy_wanted:
            _router_failover_benchmarks(em, trials, min_s, only, device)
        if hedge_wanted:
            _router_hedge_benchmarks(em, trials, min_s)
        if decode_wanted:
            _cluster_decode_benchmarks(em, trials, min_s, device)
            _cluster_drain_benchmarks(em, trials, min_s, device)
    finally:
        if own_runtime:
            rt.shutdown()
    return em.flush(quiet)


def _router_failover_benchmarks(em: SuiteEmitter, trials: int,
                                min_s: float, only: Optional[set],
                                device) -> None:
    from tosem_tpu_torch.cluster.node import RemoteNode
    from tosem_tpu_torch.cluster.supervisor import NodePool
    from tosem_tpu_torch.serve.bench_serve import VectorWorkBackend
    from tosem_tpu_torch.serve.cluster_serve import ClusterServe
    from tosem_tpu_torch.serve.core import Serve

    # single-process reference arm: the in-process serve data plane, same
    # backend, 2 in-process replica actors
    serve = Serve()
    serve.deploy("bench-ref", VectorWorkBackend, num_replicas=2,
                 max_retries=1, init_kwargs=dict(BACKEND_KW))
    h_ref = serve.get_handle("bench-ref")

    # cluster arm: 2 agents × capacity 4 (the survivor must be able to
    # re-host the victim's replicas), 4 replicas spread 2+2, 2 router
    # processes — every request crosses two process boundaries
    journal = os.path.join(tempfile.mkdtemp(prefix="bench_cluster_"),
                           "head.jsonl")
    pool = NodePool(journal_path=journal, miss_threshold=1,
                    probe_timeout=3.0)
    nodes = [RemoteNode.spawn_local(num_workers=8) for _ in range(2)]
    for i, n in enumerate(nodes):
        pool.add_node(n, name=f"n{i}")
    cs = ClusterServe(pool, num_routers=2, router_procs=True)
    try:
        dep = cs.deploy("bench-vec", BACKEND_REF, num_replicas=4,
                        strategy="spread", init_kwargs=dict(BACKEND_KW))
        h_cl = cs.get_handle("bench-vec")
        h_ref.call({"x": 0}, timeout=120.0)       # warm both arms
        h_cl.call({"x": 0})

        throughput_ids = {"cluster_router_c16", "cluster_single_ref_c16",
                          "cluster_vs_single"}
        if only is None or throughput_ids & only:
            cl16, ref16, ratios = [], [], []
            for _ in range(max(trials, 1)):
                # one A/B round: both arms see the same host phase
                a = closed_loop(h_cl.call, 16, min_s,
                                lambda i, k: {"x": i})
                b = closed_loop(h_ref.call, 16, min_s,
                                lambda i, k: {"x": i}, timeout=60.0)
                cl16.append(a)
                ref16.append(b)
                ratios.append(a / b if b else float("inf"))
            em.emit("cluster_router_c16",
                    "cluster serve 16 clients via router tier", cl16)
            em.emit("cluster_single_ref_c16",
                    "single-process serve 16 clients reference", ref16)
            em.emit("cluster_vs_single",
                    "cluster vs single-process throughput", ratios,
                    unit="x")

        # ---- failover: node kill under live traffic -------------------
        if em.want("cluster_failover_recovery"):
            # pre/post windows are seconds apart on a bimodal host, so
            # raw throughput is NOT comparable across the kill
            # (measured 6x phase swings). Recovery is therefore scored
            # against a CONTROL cluster deployment that shares the
            # victim arm's whole stack (same backend, replica count,
            # router tier) but is packed on the surviving node, with
            # both fleets run CONCURRENTLY over the same wall-clock
            # window (paired_loop) — a phase flip or GIL convoy hits
            # both arms in the same milliseconds. Even so, identical
            # deployments measure up to ~1.3x apart round to round on
            # this 2-CPU host (driver-GIL scheduling luck), so the
            # ratio-of-medians is asserted only against a CATASTROPHIC
            # bound (0.5x: a real failover bug — retry storms, lost
            # capacity, per-request timeouts — is a 5-100x drop), while
            # the deterministic acceptance criteria are hard: zero
            # client-surfaced errors, full re-placement. The recorded
            # row (capped at 1.0) lets the perf gate track recovery
            # release over release at the standard threshold.
            ctrl = cs.deploy("bench-control", BACKEND_REF,
                             num_replicas=4, strategy="pack",
                             init_kwargs=dict(BACKEND_KW))
            h_ctrl = cs.get_handle("bench-control")
            h_ctrl.call({"x": 0})
            ctrl_nodes = {r.node for r in ctrl.replicas}
            # the victim hosts failover-arm replicas but NO control
            # replicas (the control must ride through the kill intact)
            victim = next(r.node for r in dep.replicas
                          if r.node not in ctrl_nodes)

            def paired_ratio():
                a, b = paired_loop(h_cl.call, h_ctrl.call, 8, min_s,
                                   lambda i, k: {"x": i})
                return a, (a / b if b else float("inf"))

            import statistics
            pre = [paired_ratio() for _ in range(3)]
            pre_med = statistics.median(r for _, r in pre)
            live = pool.live_nodes()

            killer_done = threading.Event()

            def killer():
                # kill mid-window, then drive the detector so death is
                # DISCOVERED (probe path), not merely announced
                time.sleep(min_s / 2)
                live[victim].kill()
                while victim in pool.live_nodes():
                    pool.detector.check_once()
                killer_done.set()

            kt = threading.Thread(target=killer)
            kt.start()
            completed, errors = _fleet_with_errors(
                h_cl, 16, duration_s=max(3.0, 4 * min_s))
            kt.join()
            if not killer_done.is_set() or victim in pool.live_nodes():
                raise RuntimeError("victim node was never declared dead")
            if errors:
                raise RuntimeError(
                    f"{len(errors)} logical requests surfaced errors "
                    f"across the node kill (first: {errors[0]!r}) — "
                    "failover must lose nothing beyond transparent "
                    "retries")
            survivors = {r.node for r in dep.replicas}
            if victim in survivors or len(dep.replicas) != 4:
                raise RuntimeError(
                    f"replicas not re-placed off {victim}: "
                    f"{[(r.replica_id, r.node) for r in dep.replicas]}")
            post = [paired_ratio() for _ in range(3)]
            post_med = statistics.median(r for _, r in post)
            recovery = post_med / pre_med if pre_med else 0.0
            # the reference raises below its catastrophic 0.5x bound; a
            # throughput ratio is a speed figure here, reported with
            # that floor beside it
            # recorded capped at 1.0 ("fully recovered"): an above-1.0
            # raw ratio (noise favoring the post window) would bake an
            # unmeetable baseline into the perf gate. Enforcement is
            # split: the in-bench hard-fail above catches catastrophic
            # (<0.5x) breakage deterministically, while the >=0.8x
            # acceptance level is held by this gated row's baseline +
            # threshold across runs — a single run's ratio is too
            # noisy on this host to hard-assert 0.8 (identical
            # deployments measure up to ~1.3x apart)
            row = em.emit("cluster_failover_recovery",
                          "post-node-kill throughput vs pre-kill floor",
                          [min(recovery, 1.0)], unit="x")
            if row is not None:
                # unrounded, so the floor is judged on the figure reported
                row.extra.update({
                    "raw_recovery": recovery,
                    "pre_rounds": [[round(v, 1), round(r, 2)]
                                   for v, r in pre],
                    "post_rounds": [[round(v, 1), round(r, 2)]
                                    for v, r in post],
                    "killed_node": victim,
                    "requests_through_kill": completed,
                    "errors_through_kill": len(errors),
                    "reference_floor": 0.5,
                    "floor_met": recovery >= 0.5})
            erow = em.emit("cluster_failover_errors",
                           "client-surfaced errors across node kill",
                           [float(len(errors))], unit="errors")
            if erow is not None:
                erow.extra["completed"] = completed
            cs.delete("bench-control")

        # ---- sharded parity (not gated: fresh-process torch import) ---
        if em.want("cluster_sharded_parity"):
            import numpy as np
            from tosem_tpu_torch.serve.backends import ShardedAttentionBackend
            t0 = time.perf_counter()
            cs.deploy("bench-shard", ShardedAttentionBackend,
                      num_replicas=1, sharding=(1, 2),
                      init_kwargs={"batch": 2, "heads": 2, "seq": 128,
                                   "dim": 64, "device": str(device)},
                      warmup_shapes=[0])
            h_sh = cs.get_handle("bench-shard")
            out = h_sh.call({"seed": 7})
            ref = ShardedAttentionBackend.reference(
                {"seed": 7}, batch=2, heads=2, seq=128, dim=64,
                device=device)
            got = np.asarray(out["out"])
            if got.tobytes() != ref.tobytes():
                raise RuntimeError(
                    "sharded dp×tp response is not bit-identical to the "
                    f"single-process reference (max abs diff "
                    f"{np.abs(got - ref).max()})")
            row = em.record("cluster_sharded_parity",
                            "sharded replica bit-identity vs reference",
                            1.0, 0.0, unit="bool")
            row.extra.update({"mesh": out["mesh"],
                              "devices": out["devices"],
                              "deploy_s": round(time.perf_counter() - t0,
                                                1)})
            cs.delete("bench-shard")

        # ---- sharded PAGED DECODE parity (not gated: fresh-process
        # torch import) — the dp×tp decode kernel on a gang-reserved
        # replica must be bit-identical to the single-process lowering,
        # including the window/page_offsets/multi-token-q modes
        if em.want("cluster_paged_parity"):
            import numpy as np
            from tosem_tpu_torch.serve.backends import ShardedPagedDecodeBackend
            t0 = time.perf_counter()
            dims = {"batch": 4, "heads": 4, "head_dim": 16, "pages": 16,
                    "page_size": 8, "table_w": 4}
            cs.deploy("bench-paged", ShardedPagedDecodeBackend,
                      num_replicas=1, sharding=(2, 2),
                      init_kwargs=dict(dims, device=str(device)),
                      warmup_shapes=[0])
            h_pg = cs.get_handle("bench-paged")
            for req in ({"seed": 3}, {"seed": 4, "q_tokens": 3},
                        {"seed": 5, "q_tokens": 2, "offsets": True}):
                out = h_pg.call(dict(req))
                ref = ShardedPagedDecodeBackend.reference(
                    req, device=device, **dims)
                got = np.asarray(out["out"])
                if got.tobytes() != ref.tobytes():
                    raise RuntimeError(
                        f"sharded paged decode response for {req} is "
                        "not bit-identical to the single-process "
                        f"lowering (max abs diff "
                        f"{np.abs(got - ref).max()})")
            row = em.record("cluster_paged_parity",
                            "sharded paged decode bit-identity "
                            "(incl. multi-q/offsets)", 1.0, 0.0,
                            unit="bool")
            row.extra.update({"mesh": out["mesh"],
                              "devices": out["devices"],
                              "deploy_s": round(time.perf_counter() - t0,
                                                1)})
            cs.delete("bench-paged")
    finally:
        cs.close()
        pool.close(close_nodes=True)
        serve.delete("bench-ref")


def _router_hedge_benchmarks(em: SuiteEmitter, trials: int,
                             min_s: float) -> None:
    """Hedged vs unhedged tail latency with one chaos-slowed replica,
    interleaved A/B.

    Two in-process routers share the SAME 2-replica deployment, table
    pushes, and host phase; the only difference is the hedge knob.
    The emulated network then turns one replica's node gray (100 ms
    injected dispatch latency — ~20x the healthy service time, the
    slow-but-alive fault crash-stop detection never sees). Per round,
    both arms run the same sequential request train: the unhedged arm's
    p99 IS the injected delay (half its picks land on the gray
    replica), while the hedged arm must cap its p99 at roughly the
    quantile-derived hedge delay plus one healthy service time. Hard
    asserts: zero errors on both arms, hedges actually fired, and the
    hedged p99 well under the injected delay; the gated
    ``router_hedged_p99`` row holds the level release over release."""
    from tosem_tpu_torch.chaos import network as _net
    from tosem_tpu_torch.cluster.node import RemoteNode
    from tosem_tpu_torch.cluster.supervisor import NodePool
    from tosem_tpu_torch.serve.cluster_serve import ClusterServe
    from tosem_tpu_torch.serve.router import RouterCore, RouterPolicy

    if not any(em.want(b) for b in HEDGE_BENCH_IDS):
        return
    slow_s = 0.1
    pool = NodePool(miss_threshold=2, probe_timeout=3.0)
    cs = None
    try:
        for i in range(2):
            pool.add_node(RemoteNode.spawn_local(num_workers=2),
                          name=f"n{i}")
        cs = ClusterServe(
            pool, num_routers=1, router_procs=False,
            router_policy=RouterPolicy(hedge_after_s=0.02,
                                       hedge_quantile=0.9,
                                       hedge_min_samples=8))
        # the unhedged control rides the same table pushes: register it
        # before the deploy so every push reaches both routers
        unhedged = RouterCore(name="router-unhedged",
                              policy=RouterPolicy())
        with cs._lock:
            cs._routers.append(unhedged)
        cs.deploy("hedge-bench", BACKEND_REF, num_replicas=2,
                  strategy="spread", init_kwargs=dict(BACKEND_KW))
        hedged = next(r for r in cs._routers_snapshot()
                      if r is not unhedged)
        # warm clients AND the latency rings: the first calls pay
        # connection setup, and the hedge delay is a ring quantile —
        # enough healthy samples must bury the cold-start outliers
        # below the hedge quantile before the fault is armed
        for router in (hedged, unhedged):
            for i in range(32):
                router.route("hedge-bench", {"x": i})
        slow_node = cs.chaos_slow_replica_node("hedge-bench", slow_s)

        def arm_p99_ms(router, n=48):
            lat = []
            for i in range(n):
                t0 = time.perf_counter()
                router.route("hedge-bench", {"x": i})
                lat.append(time.perf_counter() - t0)
            lat.sort()
            return lat[min(int(len(lat) * 0.99), len(lat) - 1)] * 1e3

        hedged_p99, unhedged_p99, wins = [], [], []
        for _ in range(max(trials, 1)):
            # one A/B round: both arms adjacent in time
            a = arm_p99_ms(hedged)
            b = arm_p99_ms(unhedged)
            hedged_p99.append(a)
            unhedged_p99.append(b)
            wins.append(b / a if a else float("inf"))
        hst, ust = hedged.stats(), unhedged.stats()
        if hst["errors"] or ust["errors"]:
            raise RuntimeError(
                f"routed errors under the gray fault (hedged "
                f"{hst['errors']}, unhedged {ust['errors']}) — a slow "
                "node is not a dead node; nothing may fail")
        if hst["hedged"] < 1 or hst["hedge_wins"] < 1:
            raise RuntimeError(
                f"the hedged arm never hedged (fired {hst['hedged']}, "
                f"won {hst['hedge_wins']}) against a {slow_s * 1e3:.0f}"
                "ms-gray replica")
        # the reference raises when the hedged p99 reaches 0.8x the
        # injected delay: a wall-clock bound, reported on the row here
        ceiling_ms = slow_s * 1e3 * 0.8
        row = em.emit("router_hedged_p99",
                      "hedged routed p99, one chaos-slowed replica",
                      hedged_p99, unit="ms", lower_is_better=True)
        if row is not None:
            row.extra.update({
                "slow_node": slow_node,
                "injected_delay_ms": slow_s * 1e3,
                "hedges_fired": hst["hedged"],
                "hedge_wins": hst["hedge_wins"],
                "reference_ceiling_ms": ceiling_ms,
                "floor_met": max(hedged_p99) < ceiling_ms})
        em.emit("router_unhedged_p99",
                "unhedged routed p99, one chaos-slowed replica",
                unhedged_p99, unit="ms", lower_is_better=True)
        em.emit("router_hedge_tail_win",
                "unhedged vs hedged p99 under the gray fault",
                wins, unit="x")
    finally:
        if cs is not None:
            cs.close()
        pool.close(close_nodes=True)
        _net.state().reset()


# ---------------------------------------------------------------------------
# cluster-scale decode: disaggregated prefill/decode + drain-with-migration


def _decode_ids(i):
    return [(7 * i + j) % 96 + 1 for j in range(DECODE_PROMPT_LEN)]


def _decode_prompts(n):
    """Uniform decode-heavy prompts (the drain bench's fleet)."""
    return [{"ids": _decode_ids(i)} for i in range(n)]


def _mixed_request(i, k):
    """The disaggregation A/B's c16 mixed fleet: clients 0-7 are
    decode-heavy chat streams (staggered budgets de-synchronize
    turnover), clients 8-15 prefill-only embed/scoring traffic."""
    if i < 8:
        return {"ids": _decode_ids(i), "max_new_tokens": 16 + (i % 8)}
    return {"ids": _decode_ids(i), "max_new_tokens": 1}


def _cluster_decode_benchmarks(em: SuiteEmitter, trials: int,
                               min_s: float, device) -> None:
    """Disaggregated prefill/decode vs colocated, interleaved A/B on
    the MIXED c16 fleet (see :func:`_mixed_request`).

    Same backend config and page budget on both arms. The colocated
    arm runs the single-replica layout that measured FASTEST for it
    (one well-batched replica: XLA intra-op threading saturates the
    host; multi-replica colocated layouts measured 20-40% slower) —
    the baseline is colocated-at-its-best, not a strawman. The
    disaggregated arm splits the same two processes into a prefill
    replica and a decode replica: embeds resolve at admit on the
    prefill tier, chat pages stream worker→worker to the decode tier
    (live KV migration), so the step loop never stalls behind a
    prefill. Completed units = generated tokens across BOTH classes.
    Decode rounds are floored at 1.2s — a 0.4s CI window measures
    admission latency, not token throughput."""
    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    from tosem_tpu_torch.serve.batching import DecodePolicy
    from tosem_tpu_torch.serve.core import Serve

    ids = CLUSTER_SCENARIOS["decode"]
    if not any(em.want(b) for b in ids):
        return
    min_s = max(min_s, 1.2)
    serve = Serve()
    try:
        serve.deploy("bench-coloc", BertDecodeBackend,
                     init_kwargs=dict(DECODE_KW, device=str(device)),
                     num_replicas=1,
                     decode_policy=DecodePolicy(max_active=16),
                     max_retries=2,
                     warmup_shapes=[DECODE_PROMPT_LEN])
        serve.deploy("bench-disagg", BertDecodeBackend,
                     init_kwargs=dict(DECODE_KW, device=str(device)),
                     num_replicas=2,
                     decode_policy=DecodePolicy(max_active=16,
                                                prefill_replicas=1),
                     max_retries=2,
                     warmup_shapes=[DECODE_PROMPT_LEN])
        h_co = serve.get_handle("bench-coloc")
        h_di = serve.get_handle("bench-disagg")
        # warm both data paths end to end (first call pays tracing) and
        # pin the arms bit-identical on the same chat prompt
        a = h_di.call(_mixed_request(0, 0), timeout=300.0)
        b = h_co.call(_mixed_request(0, 0), timeout=300.0)
        if a["tokens"] != b["tokens"]:
            raise RuntimeError("disaggregated and colocated decode "
                               "disagree on the same prompt")
        h_di.call(_mixed_request(8, 0), timeout=300.0)
        h_co.call(_mixed_request(8, 0), timeout=300.0)
        di_rates, co_rates, ratios = [], [], []
        splits = {}
        for _ in range(max(trials, 1)):
            # one A/B round: both arms see the same host phase
            chat = [0.0, 0.0]

            def count(out, slot=0):
                n = float(len(out["generated"]))
                if n > 1:
                    chat[slot] += n
                return n
            di = closed_loop(h_di.call, 16, min_s, _mixed_request,
                             count_of=lambda o: count(o, 0),
                             timeout=300.0)
            co = closed_loop(h_co.call, 16, min_s, _mixed_request,
                             count_of=lambda o: count(o, 1),
                             timeout=300.0)
            di_rates.append(di)
            co_rates.append(co)
            ratios.append(di / co if co else float("inf"))
            splits = {"disagg_chat_tok_s": round(chat[0] / min_s, 1),
                      "coloc_chat_tok_s": round(chat[1] / min_s, 1)}
        st = serve.get_deployment("bench-disagg").stats()
        if st.get("kv_migrations", 0) < 1:
            raise RuntimeError(
                "disaggregated arm recorded zero migrations — the "
                "prefill tier never handed anything to the decode "
                f"tier (stats {st})")
        row = em.emit("cluster_decode_disagg_c16",
                      "disaggregated prefill/decode token throughput, "
                      "mixed c16", di_rates, unit="tok/s")
        if row is not None:
            row.extra.update({
                "kv_migrations": st.get("kv_migrations"),
                "prompt_len": DECODE_PROMPT_LEN,
                "fleet": "8 chat + 8 embed", **splits})
        em.emit("cluster_decode_coloc_c16",
                "colocated prefill+decode token throughput, "
                "mixed c16", co_rates, unit="tok/s")
        em.emit("cluster_decode_disagg_vs_coloc",
                "disaggregated vs colocated token throughput",
                ratios, unit="x")
    finally:
        for name in ("bench-coloc", "bench-disagg"):
            try:
                serve.delete(name)
            except Exception:
                pass


class ControlLoadBackend:
    """Fixed-service-time backend with warm/cold accounting — the
    control-plane bench's unit of work. ``warmup()`` simulates the AOT
    executable build (``compile_s``); a call served BEFORE warmup
    counts a ``cold_serve`` and pays the build inline — exactly the
    tail latency the warm-before-traffic contract must make impossible.
    ``stats()`` rides the replica's stats RPC so the bench can assert
    zero cold serves across every replica autoscaling ever placed."""

    def __init__(self, delay_s: float = 0.02, compile_s: float = 0.25):
        self._delay_s = float(delay_s)
        self._compile_s = float(compile_s)
        self._warmed = False
        self._cold_serves = 0
        self._lock = threading.Lock()

    def warmup(self, shapes):
        time.sleep(self._compile_s)
        with self._lock:
            self._warmed = True
        return {"warmed": len(shapes)}

    def call(self, request):
        with self._lock:
            cold = not self._warmed
            if cold:
                self._cold_serves += 1
                self._warmed = True        # the JIT memoizes either way
        if cold:
            time.sleep(self._compile_s)
        time.sleep(self._delay_s)
        return {"x": request.get("x", 0)}

    def stats(self):
        with self._lock:
            return {"cold_serves": self._cold_serves,
                    "warmed": self._warmed}


def _open_loop(call, rate_hz: float, duration_s: float,
               start_index: int = 0, workers: int = 48):
    """Open-loop load: requests fire on the offered-rate schedule
    whether or not earlier ones completed (closed-loop fleets
    self-throttle under overload — useless for proving admission).
    Latency is measured from the request's SCHEDULED time, so client-
    side queueing counts against the system like it does for a user.
    Returns (samples, errors): samples are ``(sched_offset_s,
    latency_s, outcome)`` with outcome ``ok`` | ``shed``."""
    import queue

    from tosem_tpu_torch.control.admission import Overloaded

    q: "queue.Queue" = queue.Queue()
    samples: List[tuple] = []
    errors: List[BaseException] = []
    lock = threading.Lock()
    start = time.perf_counter() + 0.05

    def worker():
        while True:
            item = q.get()
            if item is None:
                return
            sched, i = item
            klass = "decode" if i % 2 else "bulk"
            try:
                call({"x": i}, klass=klass)
                out = "ok"
            except Overloaded:
                out = "shed"
            except BaseException as e:  # pragma: no cover - asserted 0
                out = "error"
                with lock:
                    errors.append(e)
            dt = time.perf_counter() - sched
            with lock:
                samples.append((sched - start, dt, out))

    threads = [threading.Thread(target=worker) for _ in range(workers)]
    for t in threads:
        t.start()
    n = int(rate_hz * duration_s)
    for i in range(n):
        sched = start + i / rate_hz
        now = time.perf_counter()
        if sched > now:
            time.sleep(sched - now)
        q.put((sched, start_index + i))
    for _ in threads:
        q.put(None)
    for t in threads:
        t.join()
    return samples, errors


def _p99(samples: List[tuple], after_s: float = 0.0) -> float:
    lat = sorted(dt for off, dt, out in samples
                 if out == "ok" and off >= after_s)
    if not lat:
        return float("nan")
    return lat[min(int(len(lat) * 0.99), len(lat) - 1)]


def _sheds(samples: List[tuple], after_s: float = 0.0) -> int:
    return sum(1 for off, _, out in samples
               if out == "shed" and off >= after_s)


def run_control_benchmarks(trials: int = 1, min_s: float = 0.5,
                           quiet: bool = False,
                           only: Optional[set] = None) -> List[ResultRow]:
    """The control-plane acceptance scenario: an open-loop diurnal
    1×→8×→1× ramp over a 2-node cluster with the FULL closed loop live
    — :class:`~tosem_tpu_torch.control.plane.ControlPlane` scaling the
    deployment's replicas AND the router tier from the queue-depth
    rollup, SLO admission with decode/bulk priority classes, and
    affinity-scored placement over a model ledger.

    Deterministic acceptance criteria are hard asserts; the gated rows
    track them release over release:

    - zero UNTYPED client errors anywhere (sheds are typed);
    - zero sheds at steady state (burst-shoulder sheds allowed);
    - steady-state p99 under the deployment's latency budget;
    - the burst scales replicas up (>= 2) and both replica count and
      router-tier count RETURN TO BASELINE within the scale-down
      window;
    - zero cold-compile serves on every replica ever placed (scale-up
      warms before the routing table sees the replica)."""
    import statistics as _stats

    from tosem_tpu_torch.cluster.node import RemoteNode
    from tosem_tpu_torch.cluster.rpc import RpcClient
    from tosem_tpu_torch.cluster.supervisor import NodePool
    from tosem_tpu_torch.control import (ControlPlane, ModelLedger,
                                   PlacementScorer, ScalePolicy)
    from tosem_tpu_torch.control.admission import SLOConfig
    from tosem_tpu_torch.serve.cluster_serve import ClusterServe

    em = SuiteEmitter("control", only)
    if not any(em.want(b) for b in GATED_CONTROL_BENCHES):
        return em.flush(quiet)

    slo = SLOConfig(latency_budget_s=0.5, est_service_s=0.02,
                    target_inflight_per_replica=8,
                    classes={"decode": 10, "bulk": 0}, aging_s=0.2)
    r0 = 24.0                      # steady offered load, req/s
    burst = 8 * r0                 # the 8x diurnal peak
    steady_s, burst_s, settle_s = 2.0, 2.5, 6.0

    pool = NodePool(miss_threshold=2, probe_timeout=3.0)
    cs = None
    plane = None
    try:
        for i in range(2):
            pool.add_node(RemoteNode.spawn_local(num_workers=4),
                          name=f"n{i}")
        cs = ClusterServe(
            pool, num_routers=1, router_procs=False,
            placement_scorer=PlacementScorer(ModelLedger(
                budget_per_node=4.0)))
        dep = cs.deploy(
            "diurnal", "tosem_tpu_torch.serve.bench_cluster:ControlLoadBackend",
            num_replicas=1, strategy="pack",
            init_kwargs={"delay_s": 0.02, "compile_s": 0.25},
            warmup_shapes=[1], slo=slo)
        plane = ControlPlane(
            cs,
            deployments={"diurnal": ScalePolicy(
                min_units=1, max_units=4, target_per_unit=1.0,
                idle_ticks_before_downscale=3, max_up_per_tick=2)},
            router_policy=ScalePolicy(
                min_units=1, max_units=2, target_per_unit=4.0,
                idle_ticks_before_downscale=3, max_up_per_tick=1))
        h = cs.get_handle("diurnal")
        h.call({"x": 0}, klass="decode")      # end-to-end warm
        plane.run(interval=0.1)

        p99s, rounds_extra = [], {}
        scaleups, cold_totals = [], []
        shed_rounds, conv_rounds = [], []
        for _round in range(max(trials, 1)):
            cold_by_rid: Dict[str, int] = {}

            def harvest_cold():
                with cs._lock:
                    reps = list(dep.replicas)
                for r in reps:
                    try:
                        with RpcClient(r.address) as cli:
                            st = cli.call("stats")
                        cold_by_rid[r.replica_id] = int(
                            st.get("cold_serves", 0))
                    except Exception:
                        pass

            a_samples, a_err = _open_loop(h.call, r0, steady_s)
            max_reps = [len(dep.replicas)]
            max_routers = [cs.num_routers()]

            def watch():
                while not watch_stop.is_set():
                    max_reps[0] = max(max_reps[0], len(dep.replicas))
                    max_routers[0] = max(max_routers[0],
                                         cs.num_routers())
                    watch_stop.wait(0.05)

            watch_stop = threading.Event()
            wt = threading.Thread(target=watch)
            wt.start()
            b_samples, b_err = _open_loop(h.call, burst, burst_s,
                                          start_index=10_000)
            harvest_cold()         # replicas the burst placed, pre-drain
            c_samples, c_err = _open_loop(h.call, r0, settle_s,
                                          start_index=50_000)
            watch_stop.set()
            wt.join()
            harvest_cold()
            errors = a_err + b_err + c_err
            if errors:
                raise RuntimeError(
                    f"{len(errors)} UNTYPED client errors across the "
                    f"diurnal ramp (first: {errors[0]!r}) — overload "
                    "must shed typed, never fail raw")
            # steady state = phase A after warm shoulder + the tail of
            # phase C (after the scale-down window)
            steady_sheds = (_sheds(a_samples, after_s=0.3)
                            + _sheds(c_samples, after_s=settle_s / 2))
            if steady_sheds:
                raise RuntimeError(
                    f"{steady_sheds} requests shed at STEADY state — "
                    "admission must only shed into the burst shoulder")
            # the reference raises when this breaches the SLO's budget:
            # a wall-clock bound, reported on the row here
            p99 = max(_p99(a_samples, after_s=0.3),
                      _p99(c_samples, after_s=settle_s / 2))
            if max_reps[0] < 2:
                raise RuntimeError(
                    f"the 8x burst never scaled up (max replicas "
                    f"{max_reps[0]}) — the loop is open, not closed")
            # convergence: both axes back at baseline
            deadline = time.perf_counter() + 6.0
            while time.perf_counter() < deadline and (
                    len(dep.replicas) > 1 or cs.num_routers() > 1):
                time.sleep(0.1)
            converged = (len(dep.replicas) == 1
                         and cs.num_routers() == 1)
            if not converged:
                raise RuntimeError(
                    f"no post-burst convergence: replicas="
                    f"{len(dep.replicas)} routers={cs.num_routers()} "
                    "(baseline is 1/1)")
            cold = sum(cold_by_rid.values())
            if cold:
                raise RuntimeError(
                    f"{cold} cold-compile serves ({cold_by_rid}) — "
                    "scale-up must warm BEFORE the routing table sees "
                    "a replica")
            p99s.append(p99 * 1e3)
            scaleups.append(float(max_reps[0]))
            cold_totals.append(float(cold))
            # measured values (provably 0 / 1.0 past the hard asserts
            # above — recorded as measurements, not constants, so the
            # rows' provenance stays honest)
            shed_rounds.append(float(steady_sheds))
            conv_rounds.append(float(converged))
            rounds_extra = {
                "burst_sheds": _sheds(b_samples) + _sheds(
                    c_samples, after_s=0.0) - _sheds(
                    c_samples, after_s=settle_s / 2),
                "max_routers": max_routers[0],
                "steady_rate_hz": r0, "burst_rate_hz": burst,
                "steady_p50_ms": round(_stats.median(
                    dt for _, dt, out in a_samples
                    if out == "ok") * 1e3, 2),
                "cold_by_replica": cold_by_rid,
                "scale_history": [
                    d for d in list(plane.history)[-40:]
                    if d.get("replicas") != d.get("new_replicas")],
            }
        row = em.emit("control_steady_p99_ms",
                      "diurnal scenario steady-state p99 latency",
                      p99s, unit="ms", lower_is_better=True)
        if row is not None:
            row.extra.update(rounds_extra)
            row.extra["reference_ceiling_ms"] = slo.latency_budget_s * 1e3
            row.extra["floor_met"] = bool(
                max(p99s) < slo.latency_budget_s * 1e3)
        em.emit("control_steady_sheds",
                "typed sheds at steady state (must be zero)",
                shed_rounds, unit="errors")
        em.emit("control_burst_scaleup",
                "peak replica count reached during the 8x burst",
                scaleups, unit="replicas")
        em.emit("control_replica_convergence",
                "replica+router counts returned to baseline post-burst",
                conv_rounds, unit="bool")
        em.emit("control_cold_serves",
                "cold-compile serves across every replica placed",
                cold_totals, unit="errors")
    finally:
        if plane is not None:
            plane.stop()
        if cs is not None:
            cs.close()
        pool.close(close_nodes=True)
    return em.flush(quiet)


def _cluster_drain_benchmarks(em: SuiteEmitter, trials: int,
                              min_s: float, device) -> None:
    """Drain-with-migration vs step-0 re-admission, interleaved A/B.

    Per round: admit 8 long sequences on a 2-replica deployment, let
    the most advanced sequence pass 13/16 of its budget while all 8 are
    live, drain the replica holding the most of them (arm A: live
    migration — remaining tokens only; arm B: the step-0 re-admission —
    re-prefill plus EVERY token again), and time completion from the
    drain. The ratio is tokens-to-catch-up made wall-clock; the migrate
    arm additionally hard-asserts zero errors, zero step-0 restarts, and
    >= 1 migration.

    The reference waits for the LEAST advanced sequence to pass 13/16
    and then picks the victim from a second look at the queue: on a card
    a tiny model's step takes a few ms, so the first-admitted sequences
    finish in the gap and the drain found the victim idle (C-ref13 in
    ROADMAP.md). The port triggers on the most advanced sequence and
    picks the victim from the same snapshot of the live sequences."""
    import time as _time

    from tosem_tpu_torch.serve.backends import BertDecodeBackend
    from tosem_tpu_torch.serve.batching import DecodePolicy
    from tosem_tpu_torch.serve.core import Serve

    ids = CLUSTER_SCENARIOS["migrate"]
    if not any(em.want(b) for b in ids):
        return
    kw = dict(DECODE_KW, device=str(device))
    kw["max_new_tokens"] = 32
    prompts = _decode_prompts(8)
    # drain deep into the decode: the re-admission arm recomputes the
    # prefill plus EVERYTHING generated so far, the migration arm pays
    # a few ms of page transfer plus only the remaining steps
    drain_at = 13 * kw["max_new_tokens"] // 16

    serve = Serve()
    try:
        serve.deploy("bench-drain", BertDecodeBackend,
                     init_kwargs=kw, num_replicas=2,
                     decode_policy=DecodePolicy(max_active=8),
                     max_retries=4,
                     warmup_shapes=[DECODE_PROMPT_LEN])
        dep = serve.get_deployment("bench-drain")
        h = serve.get_handle("bench-drain")
        h.call(dict(prompts[0]), timeout=300.0)      # warm end to end
        q = dep._queue

        def drain_round(migrate):
            base = dep.stats()
            futs = [h.remote(dict(p)) for p in prompts]
            deadline = _time.time() + 120.0
            victim = None
            while _time.time() < deadline and victim is None:
                with q._lock:
                    live = list(q._active)
                    pending = len(q._pending)
                steps = [it.step for it in live]
                if steps and len(steps) == len(prompts) and not pending \
                        and max(steps) >= drain_at:
                    held: Dict[int, list] = {}
                    for it in live:
                        held.setdefault(id(it.replica), []).append(it)
                    victim = max(held.values(), key=len)[0].replica
                else:
                    _time.sleep(0.001)
            if victim is None:
                raise RuntimeError(
                    "the 8 sequences never ran together past step "
                    f"{drain_at} — nothing to drain")
            tokens_at_drain = dep.stats()["tokens_emitted"]
            t0 = _time.perf_counter()
            res = q.drain_replica(victim, migrate=migrate)
            outs = [f.result(timeout=300.0) for f in futs]
            dt = _time.perf_counter() - t0
            st = dep.stats()
            catchup = st["tokens_emitted"] - tokens_at_drain
            errs = st["sequences_err"] - base["sequences_err"]
            if errs:
                raise RuntimeError(
                    f"{errs} sequences surfaced errors across the "
                    f"drain (migrate={migrate})")
            short = [o for o in outs
                     if len(o["generated"]) != kw["max_new_tokens"]]
            if short:
                raise RuntimeError(
                    f"{len(short)} sequences completed short of the "
                    "token budget — the drain lost work")
            if migrate:
                if res["migrated"] < 1:
                    raise RuntimeError(
                        f"drain migrated nothing ({res}) — the bench "
                        "drained an idle replica")
                step0 = (st["seqs_readmitted_step0"]
                         - base["seqs_readmitted_step0"])
                if step0:
                    raise RuntimeError(
                        f"{step0} sequences restarted from step 0 "
                        "under drain-with-migration")
            return dt, catchup, res

        ratios = []
        last = {}
        for _ in range(max(trials, 1)):
            # one A/B round, adjacent in time: migrate then re-admit.
            # The gated metric is TOKENS-TO-CATCH-UP (tokens the fleet
            # must generate after the drain to finish): deterministic
            # up to drain timing, where wall-clock ratios swing 2x+
            # because the migrate arm finishes in fractions of a
            # second on this host
            dt_m, cu_m, res_m = drain_round(migrate=True)
            dt_r, cu_r, res_r = drain_round(migrate=False)
            ratios.append(cu_r / cu_m if cu_m else float("inf"))
            last = {"migrate_s": round(dt_m, 3),
                    "readmit_s": round(dt_r, 3),
                    "migrate_catchup_tokens": cu_m,
                    "readmit_catchup_tokens": cu_r,
                    "wall_ratio": round(dt_r / dt_m, 2) if dt_m else 0,
                    "drain_migrate": res_m, "drain_readmit": res_r}
        row = em.emit("cluster_drain_migrate_vs_readmit",
                      "drain recovery: migration vs step-0 "
                      "re-admission (tokens-to-catch-up ratio)", ratios,
                      unit="x")
        if row is not None:
            row.extra.update(last)
            row.extra["drain_at_step"] = drain_at
        erow = em.record("cluster_drain_errors",
                         "client-surfaced errors across drains", 0.0,
                         0.0, unit="errors")
        erow.extra["rounds"] = len(ratios)
    finally:
        try:
            serve.delete("bench-drain")
        except Exception:
            pass
