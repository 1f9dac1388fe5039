"""Remote-machine bootstrap (cluster/bootstrap.py): the SSH-shaped
training-service leg — the manager STARTS its agents over a shell
transport, runs trials through them, and tears them down
(``remoteMachineTrainingService.ts`` + ``shellExecutor.ts`` roles).

A copy of ``tests/test_bootstrap.py`` against the port's
``cluster/bootstrap.py``. The trial-driven tests (an HPO loop through
self-bootstrapped agents, elastic scaling under trial load) wait for
``tune/`` and the agents' trial plane (ROADMAP.md A14); in their place,
the service's refusal and the pool's scaling without trials.
"""
import os
import subprocess
import time

import pytest

from tosem_tpu_torch.cluster.bootstrap import (BootstrapService, CommandRunner,
                                         LocalRunner, SshRunner,
                                         bootstrap_agent)

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
    def test_bootstrap_service_names_its_roadmap_item(self):
        """Trials run on the agents' trial plane, which comes with
        tune/ (ROADMAP.md A14): the service refuses loudly and starts
        no agent."""
        with pytest.raises(NotImplementedError, match="A14"):
            BootstrapService([LocalRunner()], num_workers=1)


class TestElasticAgentPool:
    """Node-level elasticity over the shell transport: whole agents
    launched and torn down (the trial-driven load of the reference's
    tests waits for tune/, ROADMAP.md A14)."""

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
