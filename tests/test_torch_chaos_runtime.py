"""The port's chaos layer against its runtime: ``tests/test_chaos_runtime.py``
run against :mod:`tosem_tpu_torch.chaos` and :mod:`tosem_tpu_torch.runtime`
— deterministic fault injection, the hardening that survives it
(deadlines, idempotent kill/cancel, actor max_restarts) and the survival
plans through the port's runner (``run_plan(..., device="cpu")``), with
the JAX package's ``slow`` marks. Across packages: the canned plans'
``chaos --list`` lines, ``FaultPlan`` JSON read both ways, a
``SurvivalReport``'s ``to_json()`` and ``render()``, and the survival and
injections of ``split-survival`` and ``evict-heal`` in both runners.
None of these tests has a copy elsewhere.
"""
import json
import subprocess
import sys
import time

import pytest

import tosem_tpu_torch.runtime as rt
from tosem_tpu_torch.chaos import (CANNED_PLANS, ChaosController, Fault,
                                   FaultPlan, hooks)
from tosem_tpu_torch.chaos.runner import run_plan
from tosem_tpu_torch.runtime.common import DeadlineExceeded


@pytest.fixture
def runtime():
    r = rt.init(num_workers=2, memory_monitor=False)
    yield r
    rt.shutdown()


def _sleep_then(x, delay_s=0.0):
    import time as _t
    if delay_s:
        _t.sleep(delay_s)
    return x * 2


# ---------------------------------------------------------------- plans

class TestFaultPlan:
    def test_json_round_trip(self):
        plan = CANNED_PLANS["split-survival"]
        again = FaultPlan.from_json(plan.to_json())
        assert again == plan

    def test_validation(self):
        with pytest.raises(ValueError, match="unknown chaos site"):
            Fault(site="nope", action="kill_worker")
        with pytest.raises(ValueError, match="not valid at"):
            Fault(site="runtime.dispatch", action="drop_result")
        with pytest.raises(ValueError, match="1-based"):
            Fault(site="tune.step", action="crash_trial", at=0)

    def test_controller_decisions_replay_exactly(self):
        """Same plan + same event sequence → identical injections: the
        property that makes chaos tests deterministic."""
        plan = FaultPlan(seed=3, faults=[
            Fault(site="runtime.dispatch", action="kill_worker", at=2),
            Fault(site="tune.step", action="crash_trial", at=1,
                  target="t0"),
        ])
        events = ([("runtime.dispatch", None)] * 4
                  + [("tune.step", "t1"), ("tune.step", "t0")])

        def drive():
            c = ChaosController(plan)
            decisions = [c.on(site, target=tgt) for site, tgt in events]
            return [(d["action"] if d else None) for d in decisions], c.log
        d1, log1 = drive()
        d2, log2 = drive()
        assert d1 == d2 == [None, "kill_worker", None, None, None,
                            "crash_trial"]
        assert log1 == log2

    def test_target_filter_counts_per_target(self):
        plan = FaultPlan(seed=0, faults=[
            Fault(site="tune.step", action="crash_trial", at=2,
                  target="a")])
        c = ChaosController(plan)
        assert c.on("tune.step", target="b") is None
        assert c.on("tune.step", target="a") is None      # a's 1st event
        assert c.on("tune.step", target="b") is None
        act = c.on("tune.step", target="a")               # a's 2nd event
        assert act is not None and act["action"] == "crash_trial"

    def test_install_uninstall(self):
        c = ChaosController(FaultPlan(seed=0, faults=[]))
        assert hooks.get_controller() is None
        with c:
            assert hooks.get_controller() is c
        assert hooks.get_controller() is None


# ------------------------------------------------------------ hardening

class TestDeadlines:
    def test_task_deadline_exceeded(self, runtime):
        f = rt.remote(_sleep_then)
        ref = f.options(deadline_s=0.3).remote(1, delay_s=30.0)
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded):
            rt.get(ref, timeout=20.0)
        # fail-fast: heartbeat-tick latency, nowhere near the 30s sleep
        assert time.monotonic() - t0 < 10.0

    def test_task_within_deadline_ok(self, runtime):
        f = rt.remote(_sleep_then)
        # generous deadline: on a loaded CI box worker spawn alone can
        # take seconds, and a flaky pass here would mask real bugs
        assert rt.get(f.options(deadline_s=60.0).remote(4),
                      timeout=90.0) == 8

    def test_deadlined_hung_worker_does_not_swallow_new_tasks(self,
                                                              runtime):
        """After a deadline fires on a still-grinding worker, fresh
        tasks must keep flowing: the hung task stays on the worker's
        inflight books (it IS still busy), so dispatch prefers the
        other worker / the steal path instead of queueing behind it."""
        f = rt.remote(_sleep_then)
        hung = f.options(deadline_s=0.2).remote(0, delay_s=120.0)
        with pytest.raises(DeadlineExceeded):
            rt.get(hung, timeout=20.0)
        refs = [f.remote(i) for i in range(4)]
        assert rt.get(refs, timeout=60.0) == [0, 2, 4, 6]

    def test_actor_call_deadline(self, runtime):
        @rt.remote
        class Slow:
            def grind(self, s):
                import time as _t
                _t.sleep(s)
                return "done"
        a = Slow.remote()
        with pytest.raises(DeadlineExceeded):
            rt.get(a.grind.options(deadline_s=0.3).remote(10.0),
                   timeout=10.0)

    def test_actor_class_deadline_default(self, runtime):
        """@remote(deadline_s=…) on a class bounds EVERY method call."""
        @rt.remote(deadline_s=0.3)
        class Slow:
            def grind(self, s):
                import time as _t
                _t.sleep(s)
                return "done"
        a = Slow.remote()
        with pytest.raises(DeadlineExceeded):
            rt.get(a.grind.remote(10.0), timeout=10.0)

    def test_deadline_exported_from_package(self):
        import tosem_tpu_torch
        assert tosem_tpu_torch.DeadlineExceeded is DeadlineExceeded


class TestIdempotentKillCancel:
    def test_double_kill_actor(self, runtime):
        @rt.remote
        class A:
            def ping(self):
                return "pong"
        a = A.remote()
        assert rt.get(a.ping.remote(), timeout=30.0) == "pong"
        rt.kill(a)
        rt.kill(a)                       # second kill: clean no-op
        with pytest.raises(rt.ActorDiedError):
            rt.get(a.ping.remote(), timeout=10.0)
        rt.kill(a)                       # kill after observed death: no-op

    def test_kill_unknown_actor_id(self, runtime):
        runtime.kill_actor(b"\x00" * 16)     # never raises

    def test_cancel_twice_and_after_completion(self, runtime):
        f = rt.remote(_sleep_then)
        ref = f.remote(3)
        assert rt.get(ref, timeout=30.0) == 6
        rt.cancel(ref)                   # finished: best-effort no-op
        assert rt.get(ref, timeout=5.0) == 6
        slow = f.remote(1, delay_s=30.0)
        rt.cancel(slow)
        rt.cancel(slow)                  # double cancel: no KeyError/hang
        with pytest.raises(rt.TaskCancelledError):
            rt.get(slow, timeout=10.0)

    def test_cancel_put_ref_is_noop(self, runtime):
        ref = rt.put({"k": 1})
        rt.cancel(ref)
        assert rt.get(ref, timeout=5.0) == {"k": 1}

    def test_chaos_double_kill_worker_process(self, runtime):
        """Chaos killing an actor's process twice (second SIGKILL on a
        corpse) must not corrupt runtime state."""
        from tosem_tpu_torch.chaos.injector import crash_actor_process
        @rt.remote(max_restarts=1)
        class A:
            def ping(self):
                return "pong"
        a = A.remote()
        assert rt.get(a.ping.remote(), timeout=30.0) == "pong"
        assert crash_actor_process(a._actor_id)
        crash_actor_process(a._actor_id)     # racing double-crash
        # restart policy brings it back (possibly after a failed call)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            try:
                assert rt.get(a.ping.remote(), timeout=10.0) == "pong"
                break
            except rt.ActorDiedError:
                time.sleep(0.1)
        else:
            pytest.fail("actor never came back after chaos crash")


class TestActorRestarts:
    def test_restart_replays_init_and_exhaustion_is_typed(self, runtime):
        from tosem_tpu_torch.chaos.injector import crash_actor_process
        @rt.remote(max_restarts=1)
        class Counter:
            def __init__(self):
                self.n = 0
            def inc(self):
                self.n += 1
                return self.n
        c = Counter.remote()
        assert rt.get(c.inc.remote(), timeout=30.0) == 1
        assert rt.get(c.inc.remote(), timeout=30.0) == 2
        crash_actor_process(c._actor_id)
        # wait for the restart to land, then the replayed init means a
        # FRESH counter (in-memory state is lost, init is re-run)
        deadline = time.monotonic() + 30.0
        value = None
        while time.monotonic() < deadline:
            try:
                value = rt.get(c.inc.remote(), timeout=10.0)
                break
            except rt.ActorDiedError:
                time.sleep(0.1)
        assert value == 1, "restarted actor must replay __init__"
        # second crash exhausts max_restarts=1 → typed terminal error
        crash_actor_process(c._actor_id)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            try:
                rt.get(c.inc.remote(), timeout=10.0)
                time.sleep(0.1)
            except rt.ActorDiedError:
                break                    # typed error surfaced: done
        else:
            pytest.fail("exhausted actor kept answering")

    def test_killed_mid_call_restarts(self, runtime):
        plan = FaultPlan(seed=1, faults=[
            Fault(site="runtime.dispatch", action="kill_worker", at=2)])
        @rt.remote(max_restarts=2)
        class Echo:
            def say(self, x):
                return x
        a = Echo.remote()
        with ChaosController(plan):
            assert rt.get(a.say.remote("a"), timeout=30.0) == "a"
            # 2nd dispatch is chaos-killed mid-call → ActorDiedError
            with pytest.raises(rt.ActorDiedError):
                rt.get(a.say.remote("b"), timeout=30.0)
        # restart policy revives it for later calls
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            try:
                assert rt.get(a.say.remote("c"), timeout=10.0) == "c"
                break
            except rt.ActorDiedError:
                time.sleep(0.1)
        else:
            pytest.fail("actor never restarted after chaos kill")


# ------------------------------------------------------- fault injection

class TestRuntimeFaults:
    def test_dropped_result_is_redelivered(self, runtime):
        plan = FaultPlan(seed=5, faults=[
            Fault(site="runtime.result", action="drop_result", at=1)])
        f = rt.remote(_sleep_then)
        with ChaosController(plan) as chaos:
            ref = f.remote(21)
            assert rt.get(ref, timeout=60.0) == 42
            assert chaos.injections("runtime.result")

    def test_delayed_result_arrives_late_but_correct(self, runtime):
        plan = FaultPlan(seed=8, faults=[
            Fault(site="runtime.result", action="delay_result", at=1,
                  delay_s=0.5)])
        f = rt.remote(_sleep_then)
        with ChaosController(plan) as chaos:
            t0 = time.monotonic()
            ref = f.remote(5)
            assert rt.get(ref, timeout=60.0) == 10
            assert time.monotonic() - t0 >= 0.5   # the delay really held
            assert chaos.injections("runtime.result")

    def test_evicted_store_object_heals_via_lineage(self, runtime):
        """PR 1 made eviction fail fast and typed; the recovery layer
        now HEALS it: get() re-executes the producing task from lineage
        and returns the correct value with no user-visible error."""
        plan = FaultPlan(seed=6, faults=[
            Fault(site="runtime.store", action="evict_object", at=1)])

        def big(n):
            return b"x" * n
        f = rt.remote(big)
        with ChaosController(plan) as chaos:
            ref = f.remote(2 << 20)          # over INLINE_THRESHOLD
            assert rt.get(ref, timeout=60.0) == b"x" * (2 << 20)
            assert chaos.injections("runtime.store")


class TestSurvivalPlans:
    def test_split_survival_acceptance(self):
        """The acceptance-criteria plan: 2 of 4 workers killed, one
        result message dropped, one tune trial crashed — every task
        finishes correctly and the trial RESUMES from its checkpoint."""
        rep = run_plan(CANNED_PLANS["split-survival"], device="cpu")
        assert rep.ok, rep.render()
        assert rep.counts["tasks_correct"] == 16
        assert rep.counts["trial_failures"] == 1      # crashed once…
        assert rep.counts["trial_iterations"] >= 8    # …and caught up
        acts = sorted(i["action"] for i in rep.injections)
        assert acts == ["crash_trial", "drop_result", "kill_worker",
                        "kill_worker"]

    @pytest.mark.slow
    def test_worker_carnage_survives(self):
        rep = run_plan(CANNED_PLANS["worker-carnage"], device="cpu")
        assert rep.ok, rep.render()
        assert rep.counts["tasks_correct"] == 24

    def test_evict_heal_reconstructs(self):
        """The recovery-layer acceptance half: evictions of live
        objects are healed by lineage reconstruction, not surfaced."""
        rep = run_plan(CANNED_PLANS["evict-heal"], device="cpu")
        assert rep.ok, rep.render()
        assert rep.counts["objects_evicted"] == 2
        assert rep.counts["objects_reconstructed"] >= 1
        assert rep.counts["tasks_correct"] == 4

    @pytest.mark.slow
    def test_node_kill_heal_survives(self):
        rep = run_plan(CANNED_PLANS["node-kill-heal"], device="cpu")
        assert rep.ok, rep.render()
        assert rep.counts["tasks_correct"] == 8
        assert rep.counts["nodes_killed"] == 1

    @pytest.mark.slow
    def test_train_preempt_resumes_bit_exact(self):
        rep = run_plan(CANNED_PLANS["train-preempt"], device="cpu")
        assert rep.ok, rep.render()
        assert rep.counts["preempted"] == 1
        assert rep.counts["steps_total"] == 10

    @pytest.mark.slow
    def test_state_plane_survival_acceptance(self):
        """The self-healing acceptance plan: a live object evicted, a
        worker killed mid-task, AND a node agent killed — the workload
        completes with zero user-visible errors."""
        rep = run_plan(CANNED_PLANS["state-plane-survival"],
                       device="cpu")
        assert rep.ok, rep.render()
        assert rep.counts["runtime_tasks_correct"] == 6
        assert rep.counts["pool_tasks_correct"] == 6
        acts = sorted(i["action"] for i in rep.injections)
        assert acts == ["evict_object", "kill_node", "kill_worker"]


# ------------------------------------------------------ across packages


def _cli(pkg, *args):
    return subprocess.run([sys.executable, "-m", f"{pkg}.cli", "chaos",
                           *args], capture_output=True, text=True,
                          timeout=300)


class TestAcrossPackages:
    def test_list_prints_the_same_plans(self):
        """``chaos --list`` of both packages: the same 17 lines."""
        port, ref = _cli("tosem_tpu_torch", "--list"), _cli("tosem_tpu",
                                                            "--list")
        assert port.returncode == ref.returncode == 0, port.stderr
        assert port.stdout == ref.stdout
        assert len(port.stdout.splitlines()) == len(CANNED_PLANS) == 17

    @pytest.mark.parametrize("name", sorted(CANNED_PLANS))
    def test_fault_plans_read_both_ways(self, name):
        from tosem_tpu.chaos.plan import CANNED_PLANS as REF_PLANS
        from tosem_tpu.chaos.plan import FaultPlan as RefPlan
        port, ref = CANNED_PLANS[name], REF_PLANS[name]
        assert json.loads(port.to_json()) == json.loads(ref.to_json())
        assert FaultPlan.from_json(ref.to_json()) == port
        assert RefPlan.from_json(port.to_json()) == ref

    def test_report_text_equals_the_reference_s(self):
        from tosem_tpu.chaos.runner import SurvivalReport as RefReport
        from tosem_tpu_torch.chaos.runner import SurvivalReport
        fields = dict(plan="split-survival", seed=42, ok=False,
                      counts={"tasks_correct": 15, "tasks_submitted": 16},
                      injections=[{"seq": 4, "site": "runtime.dispatch",
                                   "target": "task",
                                   "action": "kill_worker"},
                                  {"seq": 9, "site": "tune.step",
                                   "target": None,
                                   "action": "crash_trial"}],
                      notes=["wrong results for tasks [3]"],
                      elapsed_s=1.25)
        port, ref = SurvivalReport(**fields), RefReport(**fields)
        assert port.to_json() == ref.to_json()
        assert port.render() == ref.render()

    @pytest.mark.parametrize("name", ["split-survival", "evict-heal"])
    def test_both_runners_inject_the_same_faults(self, name):
        """Both runners survive the plan with the same injections. An
        injection's ``seq`` is its place among every site's events, which
        interleave as the threads run (the JAX package's own
        ``split-survival`` puts its dropped result at #52, #63 or #64 from
        run to run), so it is left out; which faults fire, at which site,
        on what target and in each site's order is decided by the plan's
        per-fault event counts and must agree."""
        from tosem_tpu.chaos.plan import CANNED_PLANS as REF_PLANS
        from tosem_tpu.chaos.runner import run_plan as ref_run_plan
        port = run_plan(CANNED_PLANS[name], device="cpu")
        ref = ref_run_plan(REF_PLANS[name])
        assert port.ok and ref.ok, (port.render(), ref.render())

        def by_site(rep):
            out = {}
            for e in rep.injections:
                out.setdefault(e["site"], []).append(
                    (e["action"], e["target"]))
            return out
        assert by_site(port) == by_site(ref)
