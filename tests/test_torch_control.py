"""The port's control plane (``tosem_tpu_torch/control/``, the
autoscalers, ``ClusterServe.scale``): ``tests/test_control.py`` run
against the port — the shared scaling policy core, SLO admission with
priority classes (incl. the FIFO-fairness-under-preemption-churn
contract), the pinned-ledger model multiplexing, stale-gauge removal,
the compile cache's pinned LRU, and the closed loop's demand folding +
actuation. The ``scale-under-kill`` chaos plan runs through the port's
runner in ``tests/test_torch_chaos_serve.py``. Across packages: the same
synthetic load through both packages' admission controllers sheds the same
requests, and the same inserts and pins leave both packages' compile
caches holding the same keys.

Everything here is deterministic: policy cores are pure state machines,
gates and admission take injectable clocks (the breaker/chaos
replayability contract), and the ControlPlane integration runs against
an in-memory fake of the ClusterServe actuator surface.
"""
from __future__ import annotations

import threading
import time

import pytest

from tosem_tpu_torch.control.admission import (AdmissionController, Overloaded,
                                         PriorityGate, SLOConfig)
from tosem_tpu_torch.control.multiplex import ModelLedger, PlacementScorer
from tosem_tpu_torch.control.plane import ControlPlane
from tosem_tpu_torch.control.policy import PolicyCore, ScalePolicy


# ------------------------------------------------------ shared policy core

class TestPolicyCore:
    def test_proportional_up_is_bounded_by_desired_and_step(self):
        core = PolicyCore(ScalePolicy(min_units=1, max_units=8,
                                      target_per_unit=2.0,
                                      max_up_per_tick=2))
        # demand 10 -> desired 5, but step-up is bounded at +2
        assert core.decide(1, 10) == 3
        assert core.decide(3, 10) == 5
        # demand 3 -> desired 2: never overshoot past desired
        assert core.decide(1, 3) == 2

    def test_proportional_trickle_scales_down_with_hysteresis(self):
        core = PolicyCore(ScalePolicy(min_units=1, max_units=8,
                                      target_per_unit=2.0,
                                      idle_ticks_before_downscale=2))
        # demand 1 < 4 units' target: shrink one step every 2 ticks
        assert core.decide(4, 1) == 4
        assert core.decide(4, 1) == 3
        assert core.decide(3, 1) == 3
        assert core.decide(3, 1) == 2

    def test_proportional_busy_tick_resets_hysteresis(self):
        core = PolicyCore(ScalePolicy(target_per_unit=2.0,
                                      idle_ticks_before_downscale=2))
        assert core.decide(2, 0) == 2          # idle tick 1
        assert core.decide(2, 4) == 2          # at target: counter reset
        assert core.decide(2, 0) == 2          # idle tick 1 again
        assert core.decide(2, 0) == 1          # now it shrinks

    def test_backlog_mode_launches_ahead(self):
        core = PolicyCore(ScalePolicy(min_units=1, max_units=8,
                                      target_per_unit=2.0,
                                      max_up_per_tick=4,
                                      mode="backlog"))
        # backlog barely over target still adds the FULL step (the node
        # launcher's launch-ahead semantics, unlike proportional)
        assert core.decide(1, 3) == 5
        assert core.decide(5, 100) == 8        # capped at max

    def test_backlog_mode_partial_backlog_never_downscales(self):
        core = PolicyCore(ScalePolicy(target_per_unit=10.0,
                                      idle_ticks_before_downscale=2,
                                      mode="backlog"))
        assert core.decide(4, 0) == 4          # idle tick 1
        assert core.decide(4, 1) == 4          # partial backlog: reset
        assert core.decide(4, 0) == 4          # idle tick 1 again
        assert core.decide(4, 0) == 3

    def test_mode_validated(self):
        with pytest.raises(ValueError, match="mode"):
            ScalePolicy(mode="vibes")

    def test_autoscaler_aliases_ride_the_core(self):
        # the old import paths stay importable and translate onto the
        # shared policy (the dedup satellite's contract)
        from tosem_tpu_torch.cluster.autoscaler import AutoscalerConfig
        from tosem_tpu_torch.serve.autoscale import ServeScaleConfig
        sp = ServeScaleConfig(min_replicas=2, max_replicas=6,
                              target_inflight_per_replica=3.0).to_policy()
        assert (sp.mode, sp.min_units, sp.max_units,
                sp.target_per_unit) == ("proportional", 2, 6, 3.0)
        cp = AutoscalerConfig(min_workers=1, max_workers=4,
                              backlog_per_worker=2.0).to_policy()
        assert (cp.mode, cp.max_units) == ("backlog", 4)


# ---------------------------------------------------------- priority gate

def _wait_for(cond, timeout=5.0):
    """Poll ``cond`` until it holds or ``timeout`` passes."""
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.001)


def _drain_in_order(gate, names_priorities):
    """Enqueue waiters one at a time (deterministic arrival order),
    then release slots until all are granted; returns grant order. Each
    release waits for its woken waiter to record itself before the next
    one (the reference sleeps 20 ms, which a loaded host can outrun)."""
    order = []
    lock = threading.Lock()
    threads = []

    def waiter(name, prio):
        assert gate.acquire(priority=prio, timeout=5.0)
        with lock:
            order.append(name)

    for name, prio in names_priorities:
        before = gate.waiting()
        t = threading.Thread(target=waiter, args=(name, prio))
        t.start()
        threads.append(t)
        deadline = time.time() + 2.0
        while gate.waiting() == before and time.time() < deadline:
            time.sleep(0.001)
    for i in range(len(names_priorities)):
        gate.release()
        _wait_for(lambda: len(order) > i)   # the woken waiter recorded
    for t in threads:
        t.join(timeout=5.0)
    return order


class TestPriorityGate:
    def test_grants_immediately_under_capacity(self):
        gate = PriorityGate(capacity=2)
        assert gate.acquire(timeout=0.1)
        assert gate.acquire(timeout=0.1)
        assert not gate.acquire(timeout=0.05)
        gate.release()
        assert gate.acquire(timeout=0.5)

    def test_decode_preempts_bulk_fifo_within_class(self):
        """The satellite-4 contract: under preemption churn (decode
        outranking bulk), equal-priority requests keep ARRIVAL order —
        decode1 before decode2, bulk1 before bulk2 before bulk3."""
        gate = PriorityGate(capacity=1)
        assert gate.acquire()                  # occupy the only slot
        order = _drain_in_order(gate, [
            ("bulk1", 0), ("decode1", 10), ("bulk2", 0),
            ("decode2", 10), ("bulk3", 0)])
        assert order == ["decode1", "decode2", "bulk1", "bulk2", "bulk3"]
        gate.release()

    def test_aging_bounds_bulk_starvation_under_sustained_decode(self):
        """Sustained decode load must not starve bulk forever: a waiter
        older than aging_s outranks every class (fake clock)."""
        t = [0.0]
        gate = PriorityGate(capacity=1, aging_s=1.0, clock=lambda: t[0])
        assert gate.acquire()
        order = []
        lock = threading.Lock()

        def waiter(name, prio):
            assert gate.acquire(priority=prio, timeout=5.0)
            with lock:
                order.append(name)

        threads = []
        for name, prio in [("bulk", 0), ("decode1", 10),
                           ("decode2", 10)]:
            before = gate.waiting()
            th = threading.Thread(target=waiter, args=(name, prio))
            th.start()
            threads.append(th)
            while gate.waiting() == before:
                time.sleep(0.001)
        t[0] = 0.5
        gate.release()                         # bulk not aged yet
        _wait_for(lambda: len(order) == 1)
        t[0] = 1.5                             # bulk is now > aging_s old
        gate.release()
        _wait_for(lambda: len(order) == 2)
        gate.release()
        for th in threads:
            th.join(timeout=5.0)
        assert order == ["decode1", "bulk", "decode2"]
        gate.release()

    def test_capacity_growth_wakes_waiters(self):
        gate = PriorityGate(capacity=1)
        assert gate.acquire()
        got = []

        def waiter():
            got.append(gate.acquire(timeout=2.0))

        th = threading.Thread(target=waiter)
        th.start()
        while gate.waiting() == 0:
            time.sleep(0.001)
        gate.set_capacity(2)                   # autoscaler grew the tier
        th.join(timeout=5.0)
        assert got == [True]

    def test_timeout_drops_the_waiter(self):
        gate = PriorityGate(capacity=1)
        assert gate.acquire()
        assert not gate.acquire(timeout=0.05)
        assert gate.waiting() == 0             # dropped, not leaked
        gate.release()
        assert gate.acquire(timeout=0.5)


# ----------------------------------------------------------- admission

class TestAdmission:
    def test_sheds_typed_over_budget_with_retry_after(self):
        sheds = []
        adm = AdmissionController(
            "d", SLOConfig(latency_budget_s=0.1, est_service_s=0.06,
                           target_inflight_per_replica=1),
            replicas=1, on_shed=lambda k, r: sheds.append((k, r)))
        adm.admit("bulk")                      # takes the only slot
        # (the reference also bounds this wait at 1 s of wall time; the
        # port's copy asserts no wall time under a loaded host, C-ref2)
        with pytest.raises(Overloaded):
            adm.admit("bulk")                  # waits, then slot_timeout
        threading.Thread(target=adm.release).start()
        # queue one waiter so the NEXT arrival's estimated wait
        # (position 2 x 0.06s) breaches the 0.1s budget instantly
        adm2 = AdmissionController(
            "d2", SLOConfig(latency_budget_s=0.1, est_service_s=0.06,
                            target_inflight_per_replica=1), replicas=1)
        adm2.admit("bulk")
        waiter = threading.Thread(
            target=lambda: pytest.raises(Overloaded, adm2.admit, "bulk"))
        waiter.start()
        deadline = time.time() + 2.0
        while adm2.stats()["waiting"] == 0 and time.time() < deadline:
            time.sleep(0.001)
        with pytest.raises(Overloaded) as ei:
            adm2.admit("decode")
        assert ei.value.retry_after > 0
        waiter.join(timeout=5.0)
        adm2.release()
        st = adm2.stats()
        assert st["sheds"].get("decode") == 1
        assert st["shed_total"] >= 2           # the timed-out bulk too

    def test_shards_divide_the_aggregate_budget(self):
        # the SLO is an AGGREGATE contract: two routers sharing one
        # deployment each admit half the slots, and each one's wait
        # estimate scales to its share of the service rate — scaling
        # the router tier must not multiply admitted inflight
        slo = SLOConfig(latency_budget_s=0.1, est_service_s=0.08,
                        target_inflight_per_replica=2)
        whole = AdmissionController("d", slo, replicas=2, shards=1)
        half = AdmissionController("d", slo, replicas=2, shards=2)
        assert whole.stats()["capacity"] == 4
        assert half.stats()["capacity"] == 2
        half.admit()
        half.admit()
        with pytest.raises(Overloaded):
            half.admit()               # a 1-shard controller would wait
        half.release()
        half.release()
        # re-sharding through update_replicas resizes in place
        half.update_replicas(2, shards=1)
        assert half.stats()["capacity"] == 4

    def test_scaling_replicas_raises_capacity(self):
        adm = AdmissionController(
            "d", SLOConfig(latency_budget_s=0.05, est_service_s=0.05,
                           target_inflight_per_replica=1), replicas=1)
        adm.admit()
        adm.update_replicas(2)                 # scale-up: capacity 2
        adm.admit()                            # no shed now
        adm.release()
        adm.release()

    def test_slo_roundtrip_and_class_ranks(self):
        slo = SLOConfig(latency_budget_s=0.25, est_service_s=0.01,
                        classes={"decode": 10, "bulk": 0}, aging_s=0.5)
        back = SLOConfig.from_dict(slo.to_dict())
        assert back.to_dict() == slo.to_dict()
        assert back.priority_of("decode") == 10
        assert back.priority_of("unknown") == 0
        assert back.priority_of(None) == 0


# ------------------------------------------------- model ledger / scorer

class TestModelLedger:
    def test_lru_eviction_under_budget_skips_pinned(self):
        led = ModelLedger(budget_per_node=2.0)
        led.record_warm("n0", "a")
        led.record_warm("n0", "b")
        led.pin("n0", "a", "a#r0")
        # c over budget: LRU order would evict a first, but a is pinned
        evicted = led.record_warm("n0", "c")
        assert evicted == ["b"]
        assert sorted(led.resident("n0")) == ["a", "c"]

    def test_touch_refreshes_lru_order(self):
        led = ModelLedger(budget_per_node=2.0)
        led.record_warm("n0", "a")
        led.record_warm("n0", "b")
        led.touch("n0", "a")                   # b is now coldest
        assert led.record_warm("n0", "c") == ["b"]

    def test_evict_under_pressure_and_unpin(self):
        led = ModelLedger(budget_per_node=8.0)
        led.record_warm("n0", "a", cost=2.0)
        led.record_warm("n0", "b", cost=2.0)
        led.pin("n0", "a", "r0")
        assert led.evict_under_pressure("n0", need=1.0) == ["b"]
        assert led.evict_under_pressure("n0", need=1.0) == []
        led.unpin("n0", "a", "r0")
        assert led.evict_under_pressure("n0", need=1.0) == ["a"]

    def test_drop_node_removes_residency_and_pins(self):
        led = ModelLedger()
        led.record_warm("n0", "a")
        led.pin("n0", "a", "r0")
        led.drop_node("n0")
        assert led.resident("n0") == {}
        assert led.stats()["nodes"] == {}

    def test_scorer_skips_pressure_penalty_on_warm_nodes(self):
        # re-warming a RESIDENT model evicts nothing: a full-budget
        # node that already holds the model must not be penalized into
        # losing to a cold node with marginally more capacity
        led = ModelLedger(budget_per_node=2.0)
        led.record_warm("n0", "m")
        led.record_warm("n0", "x")
        assert led.used("n0") == 2.0           # full
        sc = PlacementScorer(led, warm_bonus=2.0, pressure_penalty=1.5)
        assert sc.pick({"n0": 2, "n1": 3}, "m") == "n0"

    def test_scorer_prefers_warm_and_coresident_nodes(self):
        led = ModelLedger(budget_per_node=2.0)
        led.record_warm("n1", "m")
        sc = PlacementScorer(led)
        # equal capacity: the warm node wins
        assert sc.pick({"n0": 2, "n1": 2}, "m") == "n1"
        # co-residency beats pressure on a full ledger
        led.record_warm("n0", "x")
        led.record_warm("n0", "y")
        led.pin("n0", "x", "r")
        led.pin("n0", "y", "r")
        assert sc.pick({"n0": 2, "n1": 2}, "m",
                       co_resident={"n1": 1}) == "n1"
        assert sc.pick({}, "m") is None


# -------------------------------------------- compile-cache pinned LRU

class TestCompileCachePinnedLRU:
    def test_budget_evicts_cold_model_not_pinned(self):
        from tosem_tpu_torch.serve.compile_cache import (CompileCache,
                                                         shape_key)
        cc = CompileCache(budget=2)
        cc.get_or_build(shape_key("a", (1,), "f32"), lambda: "A1")
        cc.get_or_build(shape_key("b", (1,), "f32"), lambda: "B1")
        cc.pin("a")
        cc.get_or_build(shape_key("c", (1,), "f32"), lambda: "C1")
        assert shape_key("a", (1,), "f32") in cc      # pinned: kept
        assert shape_key("b", (1,), "f32") not in cc  # cold: evicted
        st = cc.stats()
        assert st["evicted_models"] == 1
        # explicit eviction refuses pinned models
        assert cc.evict_model("a") == 0
        cc.unpin("a")
        assert cc.evict_model("a") == 1

    def test_whole_model_evicts_together(self):
        from tosem_tpu_torch.serve.compile_cache import (CompileCache,
                                                         shape_key)
        cc = CompileCache(budget=3)
        for s in ((1,), (2,), (3,)):
            cc.get_or_build(shape_key("a", s, "f32"), lambda: "A")
        cc.get_or_build(shape_key("b", (1,), "f32"), lambda: "B")
        # a's THREE entries went together (no piecemeal palette holes)
        assert len(cc) == 1
        assert shape_key("b", (1,), "f32") in cc

    def test_variant_suffixes_share_one_eviction_group(self):
        # model_tag bases end at ')'; backends append ';step'/';mask=…'
        # AFTER it — all variants of one model must evict as one group
        from tosem_tpu_torch.serve.compile_cache import (CompileCache,
                                                         shape_key)
        tag = "bert(dim=32;seed=0)"
        cc = CompileCache(budget=2)
        cc.get_or_build(shape_key(tag + ";prefill", (1,), "f32"),
                        lambda: "P")
        cc.get_or_build(shape_key(tag + ";step", (1,), "f32"),
                        lambda: "S")
        cc.pin(tag)
        cc.get_or_build(shape_key("other(x=1;seed=0)", (1,), "f32"),
                        lambda: "O")
        # the pinned base tag protects BOTH variants; 'other' (the
        # inserting model) survives too — cache simply over budget
        assert len(cc) == 3
        cc.unpin(tag)
        cc.get_or_build(shape_key("third(y=2;seed=0)", (1,), "f32"),
                        lambda: "T")
        # coldest model now evictable: both bert variants went together
        assert shape_key(tag + ";prefill", (1,), "f32") not in cc
        assert shape_key(tag + ";step", (1,), "f32") not in cc

    def test_racing_builders_build_once(self):
        from tosem_tpu_torch.serve.compile_cache import (CompileCache,
                                                         shape_key)
        cc, built = CompileCache(), []
        gate = threading.Barrier(4)
        key = shape_key("m", (1, 16), "f32")

        def build():
            built.append(1)
            time.sleep(0.05)        # hold the key while the others race
            return "X"

        def worker(out):
            gate.wait()
            out.append(cc.get_or_build(key, build))
        got = []
        threads = [threading.Thread(target=worker, args=(got,))
                   for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert got == ["X"] * 4 and built == [1]
        st = cc.stats()
        assert (st["hits"], st["misses"], st["entries"]) == (3, 1, 1)


# ------------------------------------------------- stale-gauge removal

class TestMetricSeriesRemoval:
    def test_gauge_remove_drops_the_series(self):
        from tosem_tpu_torch.obs.metrics import Registry
        reg = Registry()
        g = reg.gauge("g", "t", labels=("node",))
        g.set(3, ("n0",))
        g.set(5, ("n1",))
        assert g.remove(("n0",))
        assert not g.remove(("n0",))           # idempotent
        text = reg.prometheus_text()
        assert 'g{node="n1"} 5.0' in text
        assert "n0" not in text                # REMOVED, not zeroed

    def test_histogram_remove(self):
        from tosem_tpu_torch.obs.metrics import Registry
        reg = Registry()
        h = reg.histogram("h", "t", labels=("d",))
        h.observe(0.1, ("x",))
        assert h.remove(("x",))
        assert "h_count" not in reg.prometheus_text()


# --------------------------------------------------- the closed loop

class _FakeCS:
    """The ClusterServe actuator surface the ControlPlane drives,
    in-memory: replicas per deployment, a router count, and canned
    router stats shaped like RouterCore.stats()."""

    class _Dep:
        def __init__(self, n):
            self.replicas = [f"r{i}" for i in range(n)]

    def __init__(self, replicas=1, routers=1):
        self.deps = {"d": self._Dep(replicas)}
        self.routers = routers
        self.depth = {}
        self.waiting = 0
        self.scaled = []

    def list_deployments(self):
        return sorted(self.deps)

    def get_deployment(self, name):
        return self.deps.get(name)

    def scale(self, name, n):
        self.scaled.append((name, n))
        dep = self.deps[name]
        cur = len(dep.replicas)
        if n > cur:
            dep.replicas += [f"r{i}" for i in range(cur, n)]
        else:
            dep.replicas = dep.replicas[:n]

    def scale_routers(self, n):
        self.routers = n
        return n

    def stats(self):
        reps = {rid: {"deployment": "d", "node": "n0", "depth": d}
                for rid, d in self.depth.items()}
        return {
            "routers": [
                {"name": f"router{i}", "replicas": reps,
                 "admission": {"d": {"waiting": self.waiting}}}
                for i in range(self.routers)],
            "nodes": {"n0": {"queue_depth":
                             sum(self.depth.values())}},
        }


class TestControlPlane:
    def test_demand_folds_max_depth_and_sums_waiting(self):
        st = {"routers": [
            {"replicas": {"r0": {"deployment": "d", "depth": 3},
                          "r1": {"deployment": "d", "depth": 1}},
             "admission": {"d": {"waiting": 2}}},
            {"replicas": {"r0": {"deployment": "d", "depth": 5}},
             "admission": {"d": {"waiting": 1}}},
        ]}
        # r0: max(3,5)=5, r1: 1, waiting: 2+1=3 -> 9 (max per replica:
        # the same request is cached once per router that saw it)
        assert ControlPlane.demand_from_stats(st) == {"d": 9.0}

    def test_loop_scales_up_and_back_down(self):
        cs = _FakeCS(replicas=1)
        plane = ControlPlane(cs, default=ScalePolicy(
            min_units=1, max_units=4, target_per_unit=2.0,
            idle_ticks_before_downscale=2, max_up_per_tick=2))
        cs.depth = {"r0": 8}                   # demand 8 -> desired 4
        plane.tick()
        assert len(cs.deps["d"].replicas) == 3
        plane.tick()
        assert len(cs.deps["d"].replicas) == 4
        cs.depth = {}                          # demand 0 -> shrink
        for _ in range(8):
            plane.tick()
        assert len(cs.deps["d"].replicas) == 1
        ups = [n for _, n in cs.scaled]
        assert ups == [3, 4, 3, 2, 1]

    def test_live_config_edit_takes_effect_next_tick(self):
        # the pre-dedup tick re-read configs every round; the cached
        # cores must rebuild when the operator swaps a policy
        cs = _FakeCS(replicas=1)
        plane = ControlPlane(cs, default=ScalePolicy(
            min_units=1, max_units=2, target_per_unit=2.0))
        cs.depth = {"r0": 20}
        plane.tick()
        assert len(cs.deps["d"].replicas) == 2          # old max
        plane.configs["d"] = ScalePolicy(min_units=1, max_units=4,
                                         target_per_unit=2.0,
                                         max_up_per_tick=4)
        plane.tick()
        assert len(cs.deps["d"].replicas) == 4          # new max honored

    def test_deleted_deployment_demand_series_removed(self):
        from tosem_tpu_torch.obs.metrics import control_plane_metrics
        cs = _FakeCS(replicas=1)
        plane = ControlPlane(cs, default=ScalePolicy(
            target_per_unit=100.0))
        cs.depth = {"r0": 3}
        plane.tick()
        demand = control_plane_metrics()["demand"]
        assert ("d",) in demand.labelsets()
        del cs.deps["d"]                       # deployment deleted
        plane.tick()
        assert ("d",) not in demand.labelsets()

    def test_router_tier_follows_total_depth(self):
        cs = _FakeCS(replicas=2, routers=1)
        plane = ControlPlane(
            cs, default=ScalePolicy(min_units=1, max_units=8,
                                    target_per_unit=100.0),
            router_policy=ScalePolicy(min_units=1, max_units=3,
                                      target_per_unit=4.0,
                                      idle_ticks_before_downscale=1))
        cs.depth = {"r0": 5, "r1": 5}          # total 10 -> 3 routers
        plane.tick()
        plane.tick()
        assert cs.routers == 3
        cs.depth = {}
        plane.tick()
        assert cs.routers == 2

    def test_min_units_zero_policy_is_clamped_not_erroring(self):
        cs = _FakeCS(replicas=2)
        plane = ControlPlane(cs, default=ScalePolicy(
            min_units=0, max_units=4, target_per_unit=2.0,
            idle_ticks_before_downscale=1))
        cs.depth = {}                          # idle: decide() walks to 0
        for _ in range(6):
            decisions = plane.tick()
        assert len(cs.deps["d"].replicas) == 1  # floored, no errors
        assert not any("error" in d for d in decisions)

    def test_router_scale_failure_is_contained(self):
        cs = _FakeCS(replicas=1, routers=1)

        def boom(n):
            raise RuntimeError("port exhaustion")

        cs.scale_routers = boom
        plane = ControlPlane(
            cs, default=ScalePolicy(target_per_unit=100.0),
            router_policy=ScalePolicy(min_units=1, max_units=3,
                                      target_per_unit=1.0))
        cs.depth = {"r0": 10}
        decisions = plane.tick()               # must not raise
        assert any(d.get("deployment") == "<routers>" and "error" in d
                   for d in decisions)

    def test_scale_failure_keeps_the_loop_alive(self):
        cs = _FakeCS(replicas=1)

        def boom(name, n):
            raise RuntimeError("no capacity")

        cs.scale = boom
        plane = ControlPlane(cs, default=ScalePolicy(
            target_per_unit=1.0))
        cs.depth = {"r0": 10}
        decisions = plane.tick()               # must not raise
        assert any("error" in d for d in decisions)


# ---------------------------------------------- cluster integration

class TestClusterScaleIntegration:
    """Real node agents + replica processes: scale-up warms before the
    table sees a replica, scale-down drains, admission sheds typed
    through the handle, and departed gauge series are REMOVED."""

    def test_scale_admission_and_stale_gauges(self):
        from tosem_tpu_torch.cluster.node import RemoteNode
        from tosem_tpu_torch.cluster.supervisor import NodePool
        from tosem_tpu_torch.obs import metrics as obs_metrics
        from tosem_tpu_torch.serve.cluster_serve import ClusterServe

        pool = NodePool(miss_threshold=2, probe_timeout=3.0)
        cs = None
        try:
            for i in range(2):
                pool.add_node(RemoteNode.spawn_local(num_workers=2),
                              name=f"cn{i}")
            cs = ClusterServe(pool, num_routers=1, router_procs=False)
            dep = cs.deploy(
                "ctl-it",
                "tosem_tpu_torch.serve.bench_cluster:ControlLoadBackend",
                num_replicas=1, strategy="pack",
                init_kwargs={"delay_s": 0.15, "compile_s": 0.1},
                warmup_shapes=[1],
                slo=SLOConfig(latency_budget_s=0.05, est_service_s=0.1,
                              target_inflight_per_replica=1,
                              classes={"decode": 10, "bulk": 0}))
            h = cs.get_handle("ctl-it")
            out = cs.scale("ctl-it", 3)
            assert out["placed"] == 2 and len(dep.replicas) == 3
            # warmed-before-traffic: every replica's first request came
            # off a filled cache (zero cold serves)
            from tosem_tpu_torch.cluster.rpc import RpcClient
            for r in dep.replicas:
                h.call({"x": 1}, klass="decode")
            for r in dep.replicas:
                with RpcClient(r.address) as cli:
                    assert cli.call("stats")["cold_serves"] == 0
            # gauge series exist for both nodes while placed there
            cs.stats()
            placed = obs_metrics.DEFAULT.get("serve_replicas_placed")
            hosted = {n for (d, n) in placed.labelsets()
                      if d == "ctl-it"}
            assert len(hosted) == 2
            # scale down to 1: the departed (deployment, node) series
            # must DISAPPEAR, not pin to zero
            out = cs.scale("ctl-it", 1)
            assert out["removed"] == 2 and len(dep.replicas) == 1
            cs.stats()
            left = {n for (d, n) in placed.labelsets() if d == "ctl-it"}
            assert left == {dep.replicas[0].node}
            # typed admission shed through the handle: occupy the one
            # slot (0.15s service), then overload past the 0.05s budget
            t = threading.Thread(
                target=lambda: h.call({"x": 2}, klass="bulk"))
            t.start()
            shed = None
            deadline = time.time() + 5.0
            while shed is None and time.time() < deadline:
                try:
                    h.call({"x": 3}, klass="decode")
                except Overloaded as e:
                    shed = e
            t.join(timeout=10.0)
            assert shed is not None
            rst = cs.stats()["routers"][0]
            assert rst["admission"]["ctl-it"]["shed_total"] >= 1
            # router-tier scale up then DOWN: the survivor must learn
            # the new shard count (stale shards = permanent
            # under-admission of the SLO budget)
            assert cs.scale_routers(2) == 2
            st2 = cs.stats()
            for rs in st2["routers"]:
                assert rs["admission"]["ctl-it"]["shards"] == 2
            assert cs.scale_routers(1) == 1
            st1 = cs.stats()
            assert st1["routers"][0]["admission"]["ctl-it"]["shards"] == 1
        finally:
            if cs is not None:
                cs.close()
            pool.close(close_nodes=True)

    def test_scale_up_warm_failure_is_contained(self):
        # a backend whose warmup RAISES must not leak its started
        # replica process/slots — and must not leak MORE every tick
        from tosem_tpu_torch.cluster.node import RemoteNode
        from tosem_tpu_torch.cluster.supervisor import NodePool
        from tosem_tpu_torch.serve.cluster_serve import ClusterServe

        pool = NodePool(miss_threshold=2, probe_timeout=3.0)
        cs = None
        try:
            node = RemoteNode.spawn_local(num_workers=2)
            pool.add_node(node, name="wf0")
            cs = ClusterServe(pool, num_routers=1, router_procs=False)
            dep = cs.deploy(
                "wf", "tests.test_torch_cluster_backends:WarmupBoom",
                num_replicas=1)
            dep.warmup_shapes = [1]     # poison future placements only
            for _ in range(2):
                out = cs.scale("wf", 2)
                assert out["placed"] == 0
                assert len(dep.replicas) == 1
            # the failed placements released their slots: the healthy
            # replica plus NO leaked processes on the agent
            live = [r for r in node.list_replicas().values()
                    if r.get("alive")]
            assert len(live) == 1
        finally:
            if cs is not None:
                cs.close()
            pool.close(close_nodes=True)


# ------------------------------------------------------ across packages


def _admission_script(seed, n=400):
    """A seeded synthetic load: admits by class, releases of held slots,
    and replica/shard changes, in one thread."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.55:
            ops.append(("admit", ["decode", "bulk", None][rng.integers(3)]))
        elif r < 0.9:
            ops.append(("release", None))
        else:
            ops.append(("resize", (int(rng.integers(1, 5)),
                                   int(rng.integers(1, 3)))))
    return ops


def _run_admission(mod, ops):
    """Play ``ops`` through one package's AdmissionController on a frozen
    clock. Whenever every slot is held, the estimated wait of the next
    arrival (one service time over the router's share of the replicas)
    exceeds the budget, so a shed is decided at arrival and no admit
    ever waits for a slot: the outcome depends on the script alone."""
    slo = mod.SLOConfig(latency_budget_s=0.01, est_service_s=1.0,
                        target_inflight_per_replica=2,
                        classes={"decode": 10, "bulk": 0}, aging_s=0.5)
    sheds = []
    adm = mod.AdmissionController(
        "d", slo, replicas=2, shards=1, clock=lambda: 0.0,
        on_shed=lambda k, r: sheds.append((k, r)))
    held, out = 0, []
    for op, arg in ops:
        if op == "admit":
            try:
                adm.admit(arg)
                held += 1
                out.append("ok")
            except mod.Overloaded as e:
                out.append(("shed", round(e.retry_after, 9)))
        elif op == "release":
            if held:
                adm.release()
                held -= 1
            out.append(held)
        else:
            adm.update_replicas(*arg)
            out.append(adm.stats()["capacity"])
    return out, sheds, adm.stats()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_sheds_the_same_requests_as_the_reference(seed):
    import tosem_tpu.control.admission as ref
    import tosem_tpu_torch.control.admission as port
    ops = _admission_script(seed)
    got = _run_admission(port, ops)
    want = _run_admission(ref, ops)
    assert got == want
    outcomes = got[0]
    assert "ok" in outcomes
    assert any(isinstance(o, tuple) and o[0] == "shed" for o in outcomes)
    assert got[2]["shed_total"] == len(got[1]) > 0


def _run_compile_cache(mod, seed, n=300):
    """A seeded mix of inserts over five models (two variants each),
    pins, unpins and explicit evictions through one package's
    CompileCache under a budget of 6; returns what each step leaves."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tags = [f"m{i}(dim=32;seed={i})" for i in range(5)]
    cc = mod.CompileCache(budget=6)
    trace = []
    for _ in range(n):
        r, tag = rng.random(), tags[rng.integers(len(tags))]
        if r < 0.7:
            key = mod.shape_key(tag + [";prefill", ";step"][rng.integers(2)],
                                (1, int(rng.integers(1, 4)) * 16), "f32")
            cc.get_or_build(key, lambda key=key: key)
        elif r < 0.8:
            cc.pin(tag, owner=f"r{rng.integers(2)}")
        elif r < 0.9:
            cc.unpin(tag, owner=f"r{rng.integers(2)}")
        else:
            trace.append(cc.evict_model(tag))
        trace.append((len(cc), tuple(cc.pinned_models())))
    st = cc.stats()
    st.pop("build_s")
    return trace, st, sorted(cc._entries, key=repr)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compile_cache_keeps_the_same_keys_as_the_reference(seed):
    import tosem_tpu.serve.compile_cache as ref
    import tosem_tpu_torch.serve.compile_cache as port
    got = _run_compile_cache(port, seed)
    assert got == _run_compile_cache(ref, seed)
    assert got[1]["evicted_models"] > 0 and got[1]["hits"] > 0
