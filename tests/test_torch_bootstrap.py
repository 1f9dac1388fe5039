"""Remote-machine bootstrap (cluster/bootstrap.py): the SSH-shaped
training-service leg — the manager STARTS its agents over a shell
transport, runs trials through them, and tears them down
(``remoteMachineTrainingService.ts`` + ``shellExecutor.ts`` roles).

A copy of ``tests/test_bootstrap.py`` against the port's
``cluster/bootstrap.py``, trials on the agents' trial plane running
``tests/test_torch_providers.py``'s trainables, plus the pool's scaling
without trials.
"""
import os
import subprocess
import time

import pytest

from tosem_tpu_torch.cluster.bootstrap import (BootstrapService,
                                               CommandRunner, LocalRunner,
                                               SshRunner, bootstrap_agent)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


class RecordingRunner(CommandRunner):
    """Mock transport: records the command, delegates to bash locally —
    proves the seam is the shell string, nothing else."""

    def __init__(self):
        self.commands = []

    def popen(self, command):
        self.commands.append(command)
        return subprocess.Popen(["bash", "-c", command],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL)


class TestBootstrapAgent:
    def test_agent_boots_and_serves_through_local_shell(self):
        agent = bootstrap_agent(LocalRunner(), num_workers=1)
        try:
            assert agent.node.health()["ok"]
            assert agent.node.submit(max, 3, 7) == 7
        finally:
            agent.teardown()

    def test_transport_seam_is_one_shell_command(self):
        runner = RecordingRunner()
        agent = bootstrap_agent(runner, num_workers=1,
                                extra_sys_path=[TESTS_DIR])
        try:
            assert len(runner.commands) == 1
            cmd = runner.commands[0]
            # env rides inside the command (ssh forwards no env) and the
            # repo is the environment — no upload step
            assert "PYTHONPATH=" in cmd and "--num-workers 1" in cmd
            assert "--path" in cmd and TESTS_DIR in cmd
            assert agent.node.health()["ok"]
        finally:
            agent.teardown()

    def test_wedged_remote_does_not_hang_manager(self):
        class WedgedRunner(CommandRunner):
            def popen(self, command):
                return subprocess.Popen(["bash", "-c", "sleep 300"],
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.DEVNULL)

        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="failed to announce"):
            bootstrap_agent(WedgedRunner(), startup_timeout=2.0)
        assert time.monotonic() - t0 < 30.0

    def test_dead_remote_raises_not_hangs(self):
        class DeadRunner(CommandRunner):
            def popen(self, command):
                return subprocess.Popen(["bash", "-c", "exit 7"],
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.DEVNULL)

        with pytest.raises(RuntimeError, match="failed to announce"):
            bootstrap_agent(DeadRunner(), startup_timeout=10.0)

    def test_ssh_runner_command_shape(self):
        """The ssh command line itself (no live ssh in CI): BatchMode
        so a password prompt can never wedge the manager."""
        r = SshRunner("worker1", user="ci", ssh_options=["-p", "2222"])
        assert r.host == "worker1"

        class Probe(SshRunner):
            def popen(self, command):
                self.argv = ["ssh", "-o", "BatchMode=yes", "-p", "2222",
                             "ci@worker1", command]
                return None

        p = Probe("worker1", user="ci", ssh_options=["-p", "2222"])
        p.popen("echo hi")
        assert p.argv[:3] == ["ssh", "-o", "BatchMode=yes"]
        assert "ci@worker1" in p.argv


class TestBootstrapService:
    def test_end_to_end_trial_through_self_bootstrapped_agent(self):
        """The acceptance: a whole HPO loop whose agents exist only
        because the service bootstrapped them."""
        from test_torch_providers import _UniformSearch

        from tosem_tpu_torch.tune.providers import run_with_service

        svc = BootstrapService([LocalRunner()], num_workers=2,
                               extra_sys_path=[TESTS_DIR])
        try:
            out = run_with_service(
                "test_torch_providers:quad_trainable",
                {"x": ("uniform", 0.0, 4.0)},
                service=svc, metric="loss", mode="min", num_samples=3,
                max_iterations=3,
                search_alg=_UniformSearch(), poll_s=0.1, timeout_s=180)
        finally:
            svc.shutdown()
        assert len(out["trials"]) == 3
        assert all(t["status"] == "SUCCEEDED" for t in out["trials"])
        assert out["best_score"] is not None

    def test_shutdown_reaps_agents(self):
        svc = BootstrapService([LocalRunner()], num_workers=1)
        node = svc._agents[0].node
        proc = svc._agents[0]._proc
        assert node.alive()
        svc.shutdown()
        # bounded reap: terminate, then kill
        deadline = time.monotonic() + 15
        while proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.1)
        assert proc.poll() is not None

    def test_failed_bootstrap_leaks_nothing(self):
        class DeadRunner(CommandRunner):
            def popen(self, command):
                return subprocess.Popen(["bash", "-c", "exit 1"],
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.DEVNULL)

        ok = LocalRunner()
        with pytest.raises(RuntimeError):
            BootstrapService([ok, DeadRunner()], num_workers=1,
                             startup_timeout=10.0)


class TestElasticAgentPool:
    """Node-level elasticity over the shell transport: whole agents
    launched and torn down, with and without trial load."""

    def test_scale_up_then_idle_scale_down(self):
        from tosem_tpu_torch.cluster.bootstrap import ElasticAgentPool

        pool = ElasticAgentPool(LocalRunner, num_workers=1,
                                min_agents=1, max_agents=2,
                                extra_sys_path=[TESTS_DIR])
        try:
            assert len(pool.agents) == 1 and len(pool.nodes) == 1
            assert pool.scale_up() == 2
            assert len(pool.agents) == 2 and len(pool.nodes) == 2
            assert all(n.alive() for n in pool.nodes)
            assert pool.scale_up() == 2            # capped at max_agents
            assert pool.scale_down()               # idle agent goes
            assert len(pool.agents) == 1 and len(pool.nodes) == 1
            assert not pool.scale_down()           # floor: min_agents
        finally:
            pool.shutdown()
        assert pool.agents == [] and pool.nodes == []

    def test_burst_scales_up_drain_scales_down(self):
        from tosem_tpu_torch.cluster.autoscaler import (Autoscaler,
                                                        AutoscalerConfig)
        from tosem_tpu_torch.cluster.bootstrap import ElasticAgentPool
        from tosem_tpu_torch.tune.providers import NodeAgentService

        svc_ref = {}

        def demand():
            svc = svc_ref.get("svc")
            if svc is None:
                return 0
            return sum(1 for j in svc.poll() if j.status == "WAITING")

        pool = ElasticAgentPool(LocalRunner, num_workers=1,
                                min_agents=1, max_agents=3,
                                extra_sys_path=[TESTS_DIR],
                                demand_fn=demand)
        try:
            # manager cap near per-agent capacity: queued trials stay
            # manager-side, so agents that join MID-RUN pick them up
            svc = NodeAgentService(pool.nodes, max_concurrent=2)
            svc_ref["svc"] = svc
            scaler = Autoscaler(
                AutoscalerConfig(min_workers=1, max_workers=3,
                                 backlog_per_worker=1.0,
                                 idle_ticks_before_downscale=2,
                                 max_scale_up_per_tick=1),
                stats_fn=pool.stats, add_fn=pool.scale_up,
                remove_fn=pool.scale_down)

            # burst: 6 slow-ish trials onto a single 1-slot agent
            for i in range(6):
                svc.submit("test_torch_providers:slow_scored_trainable",
                           {"lvl": 1.0, "sleep": 0.05}, f"t{i}", 4)
            d1 = scaler.tick()
            assert d1["added"] == 1 and len(pool.agents) == 2
            scaler.tick()
            assert len(pool.agents) == 3          # capped at max_agents
            scaler.tick()
            assert len(pool.agents) == 3

            # drain, then idle ticks terminate the extra agents
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                jobs = svc.poll()
                if all(j.status in ("SUCCEEDED", "FAILED", "CANCELED")
                       for j in jobs):
                    break
                time.sleep(0.2)
            assert all(j.status == "SUCCEEDED" for j in svc.poll())
            # live nodes list: the agents launched MID-RUN actually
            # served trials (service picked them up without a rebuild)
            served = [n.stats()["tasks_done"] for n in pool.nodes]
            assert len(served) == 3 and all(s >= 1 for s in served), served
            removed = 0
            for _ in range(10):
                removed += scaler.tick()["removed"]
                if len(pool.agents) == 1:
                    break
            assert len(pool.agents) == 1          # back to min_agents
            assert removed >= 2
        finally:
            svc_ref.clear()
            pool.shutdown()

    def test_scale_down_spares_busy_agents(self):
        from tosem_tpu_torch.cluster.bootstrap import ElasticAgentPool
        from tosem_tpu_torch.tune.providers import NodeAgentService

        pool = ElasticAgentPool(LocalRunner, num_workers=1,
                                min_agents=1, max_agents=2,
                                extra_sys_path=[TESTS_DIR])
        try:
            pool.scale_up()
            assert len(pool.agents) == 2
            svc = NodeAgentService(pool.nodes)
            # busy the NEWEST agent (round-robin: second submit)
            svc.submit("test_torch_providers:slow_scored_trainable",
                       {"lvl": 1.0, "sleep": 0.3}, "tb0", 50)
            svc.submit("test_torch_providers:slow_scored_trainable",
                       {"lvl": 1.0, "sleep": 0.3}, "tb1", 50)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if all(j.status == "RUNNING" for j in svc.poll()):
                    break
                time.sleep(0.1)
            # both agents have a live trial: idle-terminate must refuse
            assert pool.scale_down() is False
            assert len(pool.agents) == 2
            svc.cancel("tb0"); svc.cancel("tb1")
        finally:
            pool.shutdown()
