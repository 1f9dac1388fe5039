"""Fault plans: a seed plus a schedule of typed faults.

A :class:`Fault` names an injection site, an action, and a *trigger
window* over that site's event sequence: the fault fires on matching
events number ``at`` through ``at + times - 1`` (1-based, counted per
site). Because triggers are event ordinals — never wall-clock — a run
of the same workload under the same ``(seed, plan)`` injects the same
faults at the same points, which is what makes chaos tests ordinary
deterministic pytest cases (the property CuPBoP/COX-style ports get
from replayable stress harnesses).

Plans serialize to/from plain JSON dicts so they can live in test
fixtures and CI scripts. The port's copy of ``tosem_tpu/chaos/plan.py``:
the same sites, actions and canned plans, which the ``chaos`` CLI runs
through :mod:`tosem_tpu_torch.chaos.runner`.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

# NOTE: agent-internal cluster faults are NOT plan sites — node agents
# and trial workers run in their own processes, so those faults ride
# env vars (TOSEM_CHAOS_NODE_UNHEALTHY_AFTER, TOSEM_CHAOS_SLOW_HEALTH_S,
# TOSEM_CHAOS_TRIAL_CRASH_AT; see the JAX package's cluster/node.py and
# tune/trial_worker.py). cluster.submit IS a plan site: the
# NodePool router runs in the driver process (the kill lands on the
# agent subprocess, but the decision point is in-process). Listing a
# site here that nothing fires would validate and then silently never
# inject.
VALID_SITES = (
    "runtime.dispatch", "runtime.result", "runtime.store",
    "serve.dispatch", "serve.decode_step", "serve.route", "tune.step",
    "cluster.submit", "cluster.probe", "transport.send",
    "train.step", "train.dist_step",
    "control.scale",
)

VALID_ACTIONS = {
    "runtime.dispatch": ("kill_worker",),
    "runtime.result": ("drop_result", "delay_result"),
    "runtime.store": ("evict_object",),
    "serve.dispatch": ("crash_replica", "slow_replica"),
    # fired once per decode-scheduler iteration: evict_pages spills the
    # coldest active sequence's KV pages out of the pool mid-decode;
    # drain_replica live-migrates the oldest active sequence's replica
    # (sequences must continue from the CURRENT step elsewhere);
    # crash_prefill SIGKILLs the disaggregated prefill tier's first
    # replica (in-flight admits re-admit, decode-tier sequences ride on)
    "serve.decode_step": ("evict_pages", "slow_step", "drain_replica",
                          "crash_prefill"),
    # fired per client request routed through a ClusterHandle:
    # kill_router SIGKILLs the first live router process (the client
    # must fail over), kill_node SIGKILLs a node hosting one of the
    # deployment's replicas and declares it dead (the controller must
    # re-place, the routers must re-admit in-flight requests)
    # slow_node injects gray latency on the node hosting the targeted
    # deployment's last replica (the emulated network adds it to every
    # dispatch) — the tail the hedging path must absorb
    "serve.route": ("kill_router", "kill_node", "slow_node"),
    "tune.step": ("crash_trial",),
    "cluster.submit": ("kill_node",),
    # fired once per node per failure-detector sweep (target = node
    # name, BEFORE that node is probed): partition severs head↔target
    # bidirectionally in the emulated network, heal removes every
    # partition, slow_node stalls the target's probes/dispatches by
    # delay_s — the gray-failure triad
    "cluster.probe": ("partition", "heal", "slow_node"),
    # fired once per tensor stream (target = stream key, else the
    # destination address): drop severs the stream mid-flight (what a
    # partition does to an in-flight transfer), delay stalls it,
    # dup_stream replays the committed stream in full (the lost-ack
    # retry the receiver's by-key dedupe must drop exactly once)
    "transport.send": ("drop", "delay", "dup_stream"),
    "train.step": ("preempt",),
    # fired once per distributed-training step before dispatch:
    # kill_node hard-kills the node hosting the highest dp rank (the
    # trainer must shrink the dp axis and continue bit-identically);
    # slow_node makes that rank gray-slow by delay_s per backward —
    # alive to every probe, caught only by the straggler watchdog
    "train.dist_step": ("kill_node", "slow_node"),
    # fired once per control-plane scale-up placement, AFTER the target
    # node is chosen and BEFORE the replica process starts: kill_node
    # SIGKILLs exactly that node and declares it dead — the controller
    # must not count the dead node's warming replica toward capacity,
    # and admission must shed typed instead of routing to it
    "control.scale": ("kill_node",),
}


@dataclass(frozen=True)
class Fault:
    """One typed fault: fire ``action`` at ``site`` on matching events
    ``at .. at + times - 1`` (1-based ordinals of events whose target
    matches ``target``; ``target=None`` matches every event)."""

    site: str
    action: str
    at: int = 1
    times: int = 1
    target: Optional[str] = None   # deployment name / trial id / None=any
    delay_s: float = 0.0           # for delay_result / slow_replica

    def __post_init__(self) -> None:
        if self.site not in VALID_SITES:
            raise ValueError(f"unknown chaos site {self.site!r}; "
                             f"choose from {VALID_SITES}")
        if self.action not in VALID_ACTIONS[self.site]:
            raise ValueError(
                f"action {self.action!r} not valid at {self.site!r}; "
                f"choose from {VALID_ACTIONS[self.site]}")
        if self.at < 1 or self.times < 1:
            raise ValueError("at and times must be >= 1 (1-based ordinals)")
        if self.delay_s < 0:
            raise ValueError("delay_s must be >= 0")

    def window(self) -> range:
        return range(self.at, self.at + self.times)


@dataclass(frozen=True)
class FaultPlan:
    """Seed + fault schedule. The seed drives every random choice a
    controller makes (there are none in the canned plans — they pin
    their triggers — but custom plans may rely on it), so ``(seed,
    plan)`` fully determines the injection sequence for a given
    workload."""

    seed: int
    faults: List[Fault] = field(default_factory=list)
    name: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {"seed": self.seed, "name": self.name,
                "faults": [asdict(f) for f in self.faults]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultPlan":
        return cls(seed=int(d["seed"]), name=d.get("name", ""),
                   faults=[Fault(**f) for f in d.get("faults", [])])

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, blob: str) -> "FaultPlan":
        return cls.from_dict(json.loads(blob))


# --------------------------------------------------------------- canned plans
#
# Each canned plan pairs with a workload scenario of the same name in
# :mod:`tosem_tpu_torch.chaos.runner` (and the ci.sh chaos smoke step runs a
# fixed-seed subset on every PR).

def _canned() -> Dict[str, FaultPlan]:
    return {
        # kill 2 of the 4 pool workers mid-task and drop one result
        # message — the runtime must replay every affected task.
        # target="task" scopes the faults to stateless task workers
        # (runtime.dispatch/result events carry target "task" | "actor")
        "worker-carnage": FaultPlan(seed=7, name="worker-carnage", faults=[
            Fault(site="runtime.dispatch", action="kill_worker", at=3,
                  target="task"),
            Fault(site="runtime.dispatch", action="kill_worker", at=9,
                  target="task"),
            Fault(site="runtime.result", action="drop_result", at=5,
                  target="task"),
        ]),
        # crash one serve replica process and slow another request —
        # the router must retry onto survivors / the restarted replica
        "serve-flap": FaultPlan(seed=11, name="serve-flap", faults=[
            Fault(site="serve.dispatch", action="crash_replica", at=2),
            Fault(site="serve.dispatch", action="slow_replica", at=6,
                  delay_s=0.05),
        ]),
        # crash a tune trial between checkpoints — the trial must
        # resume from its last checkpoint, not restart from iteration 0
        "trial-crash": FaultPlan(seed=13, name="trial-crash", faults=[
            Fault(site="tune.step", action="crash_trial", at=5),
        ]),
        # the acceptance-criteria plan: 2 worker kills + 1 dropped
        # result + 1 trial crash, all surviving in one run. The
        # runtime faults are scoped to target="task" so the trial's
        # actor worker sees exactly ONE fault (the scheduled crash) —
        # that keeps `trial_failures == 1` a deterministic assertion
        "split-survival": FaultPlan(seed=42, name="split-survival", faults=[
            Fault(site="runtime.dispatch", action="kill_worker", at=4,
                  target="task"),
            Fault(site="runtime.dispatch", action="kill_worker", at=11,
                  target="task"),
            Fault(site="runtime.result", action="drop_result", at=7,
                  target="task"),
            Fault(site="tune.step", action="crash_trial", at=5),
        ]),
        # evict two sealed results out of the store — every later get()
        # must transparently re-derive them through lineage
        # reconstruction (zero user-visible errors, results correct)
        "evict-heal": FaultPlan(seed=17, name="evict-heal", faults=[
            Fault(site="runtime.store", action="evict_object", at=2,
                  times=2),
        ]),
        # hard-kill a node agent the instant work is routed to it — the
        # pool's failure detector + resubmit path must finish the whole
        # workload on the survivors
        "node-kill-heal": FaultPlan(seed=23, name="node-kill-heal", faults=[
            Fault(site="cluster.submit", action="kill_node", at=3),
        ]),
        # preempt training between checkpoints — the rerun must resume
        # from the latest atomic checkpoint and produce a bit-exact
        # metric history (not re-diverge, not restart from step 0)
        "train-preempt": FaultPlan(seed=29, name="train-preempt", faults=[
            Fault(site="train.step", action="preempt", at=5),
        ]),
        # the decode acceptance plan: evict KV pages mid-decode AND
        # crash the decode replica a few steps later — every sequence
        # must complete with the SAME tokens a fault-free run produces
        # (greedy decode is deterministic; spill-restore is byte-
        # preserving; replica loss re-prefills from token history)
        "decode-chaos": FaultPlan(seed=37, name="decode-chaos", faults=[
            Fault(site="serve.decode_step", action="evict_pages", at=2),
            Fault(site="serve.dispatch", action="crash_replica", at=9),
        ]),
        # the cluster-decode acceptance plan: against a DISAGGREGATED
        # prefill/decode deployment, live-drain a decode replica a few
        # steps in (its sequences must MIGRATE and continue from the
        # current step — zero step-0 restarts) and then kill the
        # prefill node mid-stream (in-flight admits re-admit on the
        # decode tier, migrated sequences must not notice) — every
        # sequence completes with fault-free-identical tokens, zero
        # surfaced errors
        "decode-migrate": FaultPlan(seed=41, name="decode-migrate",
                                    faults=[
            Fault(site="serve.decode_step", action="drain_replica",
                  at=3),
            Fault(site="serve.decode_step", action="crash_prefill",
                  at=6),
        ]),
        # the cluster-serving acceptance plan: kill a ROUTER mid-traffic
        # (clients must fail over to the surviving router), then kill a
        # REPLICA NODE a few requests later (the controller must
        # re-place its replicas on the survivor and the routers must
        # re-admit from step 0) — bounded error budget: zero
        # client-surfaced errors, every response correct
        "router-chaos": FaultPlan(seed=43, name="router-chaos", faults=[
            Fault(site="serve.route", action="kill_router", at=6),
            Fault(site="serve.route", action="kill_node", at=14),
        ]),
        # the prefix-cache acceptance plan: SIGKILL the node that owns
        # the hot shared prefix mid-session (routers have been steering
        # shared-prefix admits to it by longest-prefix match) — the
        # fleet must fall back to COLD prefill on the survivor with
        # zero surfaced errors, and every response must stay
        # bit-identical to the fault-free run (prefix reuse is an
        # optimisation, never a correctness dependency)
        "prefix-node-kill": FaultPlan(seed=71, name="prefix-node-kill",
                                      faults=[
            Fault(site="serve.route", action="kill_node", at=10),
        ]),
        # the distributed-training acceptance plan: hard-kill the node
        # hosting the highest dp rank mid-epoch — the trainer must
        # SHRINK the dp axis (rewire the reduce chain over survivors,
        # catch stragglers up worker→worker) and continue, the scenario
        # then GROWS it back via rejoin — and the whole loss trajectory
        # must stay bit-identical to single-process fit() throughout,
        # with zero surfaced errors (the reproducibility contract:
        # logical shards and the left-fold reduction order are fixed;
        # membership only moves shard boundaries)
        "train-cluster": FaultPlan(seed=47, name="train-cluster", faults=[
            Fault(site="train.dist_step", action="kill_node", at=3),
        ]),
        # the control-plane acceptance plan: a node dies in the middle
        # of an autoscaler-driven scale-up (after the controller chose
        # it as the placement target, before the replica process
        # started) — the warming replica must never be counted toward
        # capacity or routed to, overload during the capacity gap must
        # shed TYPED (Overloaded, never an untyped error or a route to
        # the corpse), and the scale-up must land on the survivor
        "scale-under-kill": FaultPlan(seed=53, name="scale-under-kill",
                                      faults=[
            Fault(site="control.scale", action="kill_node", at=1),
        ]),
        # the gray-failure detection plan: partition the head away from
        # one node (its probes start failing silently — no crash, no
        # RST), hold the cut across several sweeps, then heal. The
        # detector must move the node ALIVE → SUSPECT (router
        # de-preference fires) before declaring it dead, work must
        # keep completing on the survivor throughout, and after the
        # heal the node must rejoin and serve again — zero surfaced
        # errors end to end
        "partition-heal": FaultPlan(seed=59, name="partition-heal",
                                    faults=[
            Fault(site="cluster.probe", action="partition", at=2,
                  target="n1"),
            Fault(site="cluster.probe", action="heal", at=6,
                  target="n1"),
        ]),
        # the tail-tolerance acceptance plan: one replica's node turns
        # gray (10× dispatch latency, injected at the emulated wire) —
        # the router's quantile-derived hedge must cap routed p99
        # within 2× the healthy-fleet p99, and the backend's
        # per-request outcome ledger must show ZERO duplicated side
        # effects (first-wins, the hedge loser retires cleanly)
        "slow-node-hedge": FaultPlan(seed=61, name="slow-node-hedge",
                                     faults=[
            Fault(site="serve.route", action="slow_node", at=1,
                  target="hedged", delay_s=0.3),
        ]),
        # the split-brain acceptance plan: partition the head away from
        # BOTH nodes (it suspects the whole fleet), heal, and recover a
        # REPLACEMENT head from the journal while the old one still
        # holds its clients. Every subsequent write by the stale head —
        # journal append, replica placement, KV adopt — must be
        # rejected by epoch fencing (StaleEpochError), with zero
        # duplicate replica ownership and zero client-surfaced errors
        # through the new head
        "stale-head-fenced": FaultPlan(seed=67, name="stale-head-fenced",
                                       faults=[
            Fault(site="cluster.probe", action="partition", at=2,
                  target="n0"),
            Fault(site="cluster.probe", action="partition", at=2,
                  target="n1"),
            Fault(site="cluster.probe", action="heal", at=5,
                  target="n0"),
        ]),
        # the self-healing acceptance plan: a live object evicted, a
        # worker killed mid-task, AND a node agent killed — one run,
        # zero user-visible errors (the survival report shows
        # recoveries, not failures)
        "state-plane-survival": FaultPlan(
            seed=31, name="state-plane-survival", faults=[
                Fault(site="runtime.store", action="evict_object", at=1),
                Fault(site="runtime.dispatch", action="kill_worker", at=2,
                      target="task"),
                Fault(site="cluster.submit", action="kill_node", at=2),
            ]),
    }


CANNED_PLANS: Dict[str, FaultPlan] = _canned()
