"""The port's cluster-layer chaos and hardening:
``tests/test_chaos_cluster.py`` run against :mod:`tosem_tpu_torch.cluster`
and :mod:`tosem_tpu_torch.tune` — node drain (graceful degradation), the
agents' environment-driven health faults, trial crash-resume from
checkpoints, and the three gray-failure plans through the port's runner,
with the JAX package's ``slow`` marks. None of these tests has a copy
elsewhere.
"""
import os

import pytest

from tosem_tpu_torch.chaos.plan import CANNED_PLANS
from tosem_tpu_torch.chaos.runner import run_plan
from tosem_tpu_torch.cluster.node import (NodeDrainingError, RemoteNode,
                                          _AgentHandlers)
from tosem_tpu_torch.tune.providers import run_trial

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
COUNTING = "tosem_tpu_torch.tune.examples:counting"


# module-level so the spawn-mode agent can unpickle it by reference
def square(x):
    return x * x


class TestDrainInProcess:
    def test_drain_rejects_new_work_fast(self):
        h = _AgentHandlers(num_workers=1)
        try:
            assert h.health()["ok"]
            assert h.drain()
            assert not h.health()["ok"]
            assert h.health()["draining"]
            with pytest.raises(NodeDrainingError):
                h.run_task(b"ignored")
            h.drain()                        # idempotent
        finally:
            h.close()

    def test_chaos_unhealthy_after_env(self, monkeypatch):
        monkeypatch.setenv("TOSEM_CHAOS_NODE_UNHEALTHY_AFTER", "2")
        h = _AgentHandlers(num_workers=1)
        try:
            assert h.health()["ok"]
            assert h.health()["ok"]
            # 3rd health call crosses the chaos threshold: node drains
            assert not h.health()["ok"]
            with pytest.raises(NodeDrainingError):
                h.run_task(b"ignored")
        finally:
            h.close()

    def test_chaos_slow_health_env(self, monkeypatch):
        import time
        monkeypatch.setenv("TOSEM_CHAOS_SLOW_HEALTH_S", "0.2")
        h = _AgentHandlers(num_workers=1)
        try:
            t0 = time.monotonic()
            assert h.health()["ok"]
            assert time.monotonic() - t0 >= 0.2
        finally:
            h.close()


class TestTrialCheckpointResume:
    def test_run_trial_resumes_from_checkpoint(self, tmp_path):
        ckpt = str(tmp_path / "t.ckpt")
        out = run_trial(COUNTING, {"x": 1.0}, 4,
                        checkpoint_path=ckpt, checkpoint_freq=2)
        assert [m["training_iteration"] for m in out["metrics"]] == \
            [1, 2, 3, 4]
        assert os.path.exists(ckpt)
        # same path, higher budget: EXECUTES only 5-8 (streamed via the
        # cb) while the final result keeps the full restored history
        streamed = []
        out2 = run_trial(COUNTING, {"x": 1.0}, 8,
                         checkpoint_path=ckpt, checkpoint_freq=2,
                         metrics_cb=streamed.append)
        assert [m["training_iteration"] for m in streamed] == [5, 6, 7, 8]
        assert [m["training_iteration"] for m in out2["metrics"]] == \
            [1, 2, 3, 4, 5, 6, 7, 8]
        # the counter state itself resumed (n continues, loss = x/n)
        assert streamed[0]["n"] == 5

    def test_crash_after_last_checkpoint_keeps_history(self, tmp_path):
        """A crash after the final checkpoint resumes into ZERO new
        iterations — the result must still carry the full pre-crash
        history, not an empty metrics list."""
        ckpt = str(tmp_path / "t.ckpt")
        run_trial(COUNTING, {"x": 1.0}, 4,
                  checkpoint_path=ckpt, checkpoint_freq=2)
        out = run_trial(COUNTING, {"x": 1.0}, 4,
                        checkpoint_path=ckpt, checkpoint_freq=2)
        assert [m["training_iteration"] for m in out["metrics"]] == \
            [1, 2, 3, 4]

    def test_generator_trainable_ignores_checkpoint(self, tmp_path):
        ckpt = str(tmp_path / "g.ckpt")
        out = run_trial("tosem_tpu_torch.tune.examples:quadratic",
                        {"x": 1.0}, 3, checkpoint_path=ckpt)
        assert len(out["metrics"]) == 3
        assert not os.path.exists(ckpt)   # no state contract → no file


@pytest.mark.slow
class TestAgentChaos:
    def test_unhealthy_node_drains_and_rejects(self, monkeypatch):
        monkeypatch.setenv("TOSEM_CHAOS_NODE_UNHEALTHY_AFTER", "2")
        node = RemoteNode.spawn_local(num_workers=1,
                                      extra_sys_path=[TESTS_DIR])
        try:
            assert node.submit(square, 3) == 9       # healthy at first
            node.health()
            node.health()
            assert not node.health()["ok"]           # chaos tripped
            with pytest.raises(NodeDrainingError):   # typed, fail-fast
                node.submit(square, 4)
            assert not node.alive()                  # probes see it too
        finally:
            node.close()

    def test_explicit_drain_rpc(self):
        node = RemoteNode.spawn_local(num_workers=1,
                                      extra_sys_path=[TESTS_DIR])
        try:
            assert node.submit(square, 2) == 4
            assert node.drain()
            with pytest.raises(NodeDrainingError):
                node.submit(square, 2)
        finally:
            node.close()

    def test_trial_crash_resumes_from_checkpoint(self, monkeypatch):
        """The cluster trial plane's crash-resume: a trial hard-killed at
        iteration 7 (checkpoint at 5) is resubmitted under the same id
        and RESUMES at 6 with its pre-crash history intact — the metric
        pids prove two processes contributed (restart would show one)."""
        monkeypatch.setenv("TOSEM_CHAOS_TRIAL_CRASH_AT", "7")
        node = RemoteNode.spawn_local(num_workers=1,
                                      extra_sys_path=[TESTS_DIR])
        try:
            node.start_trial("t1", COUNTING, {"x": 1.0},
                             max_iterations=10)
            st = self._wait_terminal(node, "t1")
            assert st["status"] == "FAILED"          # chaos crash landed
            node.start_trial("t1", COUNTING, {"x": 1.0},
                             max_iterations=10)      # resubmit same id
            st = self._wait_terminal(node, "t1")
            assert st["status"] == "SUCCEEDED", st
            iters = [m["training_iteration"] for m in st["metrics"]]
            assert iters == list(range(1, 11)), iters   # full history
            pids = {m["pid"] for m in st["metrics"]}
            assert len(pids) == 2, pids              # resumed, not replayed
        finally:
            node.close()

    @staticmethod
    def _wait_terminal(node, tid, timeout=60.0):
        import time
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st = node.trial_status(tid)
            if st["status"] in ("SUCCEEDED", "FAILED", "CANCELED"):
                return st
            time.sleep(0.2)
        raise AssertionError(f"trial {tid} never finished: {st}")


@pytest.mark.slow
class TestGrayFailurePlans:
    """The three gray-failure proving plans end to end: partition →
    suspect window → heal, one chaos-slowed replica under hedged
    routing, and a partitioned-away head fenced by the epoch lease."""

    def test_partition_heal_plan_survives(self):
        rep = run_plan(CANNED_PLANS["partition-heal"], device="cpu")
        assert rep.ok, rep.render()
        assert rep.counts["errors_surfaced"] == 0
        assert rep.counts["deaths"] == 0          # gray, never declared
        assert rep.counts["suspect_enters"] >= 1
        assert rep.counts["suspect_clears"] >= 1
        # the suspect window drained traffic to the healthy replica,
        # and the healed node rejoined the serving set
        assert rep.counts["replicas_serving_suspect_window"] == 1
        assert rep.counts["replicas_serving_healed"] == 2

    def test_slow_node_hedge_plan_survives(self):
        rep = run_plan(CANNED_PLANS["slow-node-hedge"], device="cpu")
        assert rep.ok, rep.render()
        assert rep.counts["errors_surfaced"] == 0
        assert rep.counts["hedge_wins"] >= 1
        # duplicate-retire safety: every request applied exactly once
        # in the side-effect ledger, hedge losers included
        assert rep.counts["ledger_applied"] == rep.counts["requests"]
        assert rep.counts["ledger_duplicates"] == 0

    def test_stale_head_fenced_plan_survives(self):
        rep = run_plan(CANNED_PLANS["stale-head-fenced"], device="cpu")
        assert rep.ok, rep.render()
        assert rep.counts["epoch_new"] > rep.counts["epoch_old"]
        # every stale-head write path rejected typed, and the new head
        # adopted each replica exactly once
        assert rep.counts["stale_writes_fenced"] == 4
        assert rep.counts["duplicate_ownership"] == 0
        assert rep.counts["errors_surfaced"] == 0
