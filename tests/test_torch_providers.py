"""Pluggable training services (NNI training_service / trialDispatcher
seam): same trial protocol, interchangeable placement backends — local
threads, isolated subprocesses, remote node agents.

A copy of ``tests/test_providers.py`` against the port's
``tune/providers.py``, ``tune/trial_worker.py`` and the node agents'
trial plane (its ``slow`` marks kept). Trial processes import this
module by name (``test_torch_providers:...``), so it imports nothing of
either package at its top.
"""
import os
import time

import pytest

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


# importable trial targets (spawned processes / agents import by name)
def quad_trainable(config):
    x = config["x"]
    for i in range(3):
        yield {"loss": (x - 2.0) ** 2 + 1.0 / (i + 1)}


def crashing_trainable(config):
    yield {"loss": 1.0}
    raise RuntimeError("boom")


def _drive(service, num_samples=4):
    from tosem_tpu_torch.tune.providers import run_with_service
    from tosem_tpu_torch.tune.search import RandomSearch
    return run_with_service(
        "test_torch_providers:quad_trainable", {"x": ("uniform", 0.0, 4.0)},
        service=service, metric="loss", mode="min",
        num_samples=num_samples, max_iterations=5,
        search_alg=_UniformSearch(), timeout_s=300)


class _UniformSearch:
    """Minimal search alg for the provider loop (space-agnostic)."""

    def set_space(self, space, mode):
        import numpy as np
        self._rng = np.random.default_rng(0)
        self.observed = []

    def suggest(self):
        return {"x": float(self._rng.uniform(0.0, 4.0))}

    def observe(self, config, score):
        self.observed.append((config["x"], score))


class TestLocalService:
    def test_runs_trials_and_observes(self):
        from tosem_tpu_torch.tune.providers import LocalService
        svc = LocalService(max_concurrent=2)
        out = _drive(svc)
        assert len(out["trials"]) == 4
        assert all(t["status"] == "SUCCEEDED" for t in out["trials"])
        # final metric = (x-2)^2 + 1/3; best config is the x nearest 2
        xs = [t["config"]["x"] for t in out["trials"]]
        nearest = min(xs, key=lambda x: abs(x - 2.0))
        assert out["best_config"]["x"] == nearest

    def test_failure_is_contained(self):
        from tosem_tpu_torch.tune.providers import LocalService, run_with_service
        svc = LocalService()
        out = run_with_service(
            "test_torch_providers:crashing_trainable", {},
            service=svc, metric="loss", mode="min", num_samples=2,
            max_iterations=5, search_alg=_UniformSearch(), timeout_s=120)
        assert all(t["status"] == "FAILED" for t in out["trials"])
        assert out["best_config"] is None


@pytest.mark.slow
class TestSubprocessService:
    def test_process_isolated_trials(self, tmp_path):
        from tosem_tpu_torch.tune.providers import SubprocessService
        env_path = os.environ.get("PYTHONPATH", "")
        os.environ["PYTHONPATH"] = TESTS_DIR + os.pathsep + env_path
        try:
            svc = SubprocessService(max_concurrent=2,
                                    workdir=str(tmp_path))
            out = _drive(svc, num_samples=3)
        finally:
            os.environ["PYTHONPATH"] = env_path
        assert all(t["status"] == "SUCCEEDED" for t in out["trials"])
        assert out["best_score"] is not None

    def test_crash_reports_failed_not_hang(self, tmp_path):
        from tosem_tpu_torch.tune.providers import (SubprocessService,
                                              run_with_service)
        env_path = os.environ.get("PYTHONPATH", "")
        os.environ["PYTHONPATH"] = TESTS_DIR + os.pathsep + env_path
        try:
            svc = SubprocessService(workdir=str(tmp_path))
            out = run_with_service(
                "test_torch_providers:crashing_trainable", {},
                service=svc, metric="loss", mode="min", num_samples=1,
                max_iterations=5, search_alg=_UniformSearch(),
                timeout_s=300)
        finally:
            os.environ["PYTHONPATH"] = env_path
        assert out["trials"][0]["status"] == "FAILED"
        assert "boom" in out["trials"][0]["error"]


@pytest.mark.slow
class TestNodeAgentService:
    def test_trials_run_on_remote_agents(self):
        from tosem_tpu_torch.cluster.node import RemoteNode
        from tosem_tpu_torch.tune.providers import NodeAgentService
        n1 = RemoteNode.spawn_local(num_workers=2,
                                    extra_sys_path=[TESTS_DIR])
        n2 = RemoteNode.spawn_local(num_workers=2,
                                    extra_sys_path=[TESTS_DIR])
        try:
            svc = NodeAgentService([n1, n2], max_concurrent=4)
            out = _drive(svc, num_samples=4)
            assert all(t["status"] == "SUCCEEDED" for t in out["trials"])
            # both agents did work (round-robin placement)
            assert n1.stats()["tasks_done"] >= 1
            assert n2.stats()["tasks_done"] >= 1
        finally:
            n1.kill()
            n2.kill()


@pytest.mark.slow
class TestExperimentServiceSeam:
    def test_experiment_runs_via_subprocess_service(self, tmp_path):
        from tosem_tpu_torch.tune.experiment import ExperimentManager
        env_path = os.environ.get("PYTHONPATH", "")
        os.environ["PYTHONPATH"] = TESTS_DIR + os.pathsep + env_path
        try:
            mgr = ExperimentManager(path=str(tmp_path / "exp.db"))
            name = mgr.create({
                "name": "svc-exp",
                "trainable": "test_torch_providers:quad_trainable",
                "space": {"x": {"type": "uniform", "low": 0.0,
                                "high": 4.0}},
                "metric": "loss", "mode": "min",
                "num_samples": 2, "max_iterations": 3,
                "max_concurrent": 2,
                "training_service": "subprocess",
            })
            state = mgr.run(name)
        finally:
            os.environ["PYTHONPATH"] = env_path
        assert state["status"] == "done"
        assert state["training_service"] == "subprocess"
        assert state["n_trials"] == 2
        assert state["best_score"] is not None


def slow_scored_trainable(config):
    """Long-running trial: metric level set by config, pace by 'sleep' —
    the shape mid-flight cancellation tests need."""
    for i in range(50):
        time.sleep(config.get("sleep", 0.1))
        yield {"acc": config["lvl"] * (1.0 + 0.01 * i)}


def _wait_status(svc, tid, statuses, timeout=60.0, min_metrics=0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        job = {j.trial_id: j for j in svc.poll()}[tid]
        if job.status in statuses and len(job.metrics) >= min_metrics:
            return job
        time.sleep(0.05)
    raise TimeoutError(f"{tid} never reached {statuses} "
                       f"(last: {job.status}, {len(job.metrics)} metrics)")


class _ScriptedSearch:
    """Deterministic config sequence (isolates the scheduler's role)."""

    def __init__(self, configs):
        self._configs = list(configs)

    def set_space(self, space, mode):
        pass

    def suggest(self):
        return dict(self._configs.pop(0))

    def observe(self, config, score):
        pass


class TestCancelRunning:
    """cancelTrialJob on a live job (nnimanager.ts:633) — every
    provider must stop a RUNNING trial, keeping partial metrics."""

    def test_local_cancel_mid_flight(self):
        from tosem_tpu_torch.tune.providers import LocalService
        svc = LocalService(max_concurrent=2)
        svc.submit("test_torch_providers:slow_scored_trainable",
                   {"lvl": 1.0, "sleep": 0.1}, "t0", 50)
        _wait_status(svc, "t0", ("RUNNING",), min_metrics=1)
        svc.cancel("t0")
        job = _wait_status(svc, "t0", ("CANCELED",))
        assert 1 <= len(job.metrics) < 50      # partials survive

    def test_subprocess_kill_mid_flight_streams_progress(self, tmp_path):
        from tosem_tpu_torch.tune.providers import SubprocessService
        svc = SubprocessService(max_concurrent=2, workdir=str(tmp_path))
        env = os.environ.get("PYTHONPATH", "")
        os.environ["PYTHONPATH"] = TESTS_DIR + os.pathsep + env
        try:
            svc.submit("test_torch_providers:slow_scored_trainable",
                       {"lvl": 1.0, "sleep": 0.1}, "t0", 50)
            # the progress side channel exposes metrics WHILE RUNNING
            job = _wait_status(svc, "t0", ("RUNNING",), min_metrics=2)
            assert job.status == "RUNNING" and len(job.metrics) >= 2
            svc.cancel("t0")
            job = _wait_status(svc, "t0", ("CANCELED",))
            assert 2 <= len(job.metrics) < 50
        finally:
            svc.shutdown()
            os.environ["PYTHONPATH"] = env

    def test_node_agent_kill_mid_flight(self):
        from tosem_tpu_torch.cluster.node import RemoteNode
        from tosem_tpu_torch.tune.providers import NodeAgentService
        node = RemoteNode.spawn_local(num_workers=2,
                                      extra_sys_path=[TESTS_DIR])
        try:
            svc = NodeAgentService([node])
            svc.submit("test_torch_providers:slow_scored_trainable",
                       {"lvl": 1.0, "sleep": 0.1}, "t0", 50)
            job = _wait_status(svc, "t0", ("RUNNING",), min_metrics=1)
            svc.cancel("t0")
            job = _wait_status(svc, "t0", ("CANCELED",))
            assert 1 <= len(job.metrics) < 50
        finally:
            node.kill()

    def test_asha_stops_running_remote_trial(self):
        """The VERDICT acceptance: ASHA cancels a RUNNING trial on a
        remote agent mid-flight through the service loop."""
        from tosem_tpu_torch.cluster.node import RemoteNode
        from tosem_tpu_torch.tune.providers import run_with_service, NodeAgentService
        from tosem_tpu_torch.tune.schedulers import ASHAScheduler
        node = RemoteNode.spawn_local(num_workers=2,
                                      extra_sys_path=[TESTS_DIR])
        try:
            svc = NodeAgentService([node])
            # the good trial paces faster, so it reaches every ASHA rung
            # first and sets the cutoff the bad trial then misses
            out = run_with_service(
                "test_torch_providers:slow_scored_trainable",
                {"lvl": ("uniform", 0.0, 1.0)},
                service=svc, metric="acc", mode="max", num_samples=2,
                max_iterations=12,
                search_alg=_ScriptedSearch([
                    {"lvl": 1.0, "sleep": 0.05},
                    {"lvl": 0.1, "sleep": 0.2}]),
                scheduler=ASHAScheduler(max_t=100, grace_period=2,
                                        reduction_factor=2),
                max_in_flight=2, poll_s=0.1, timeout_s=120)
        finally:
            node.kill()
        by_id = {t["trial_id"]: t for t in out["trials"]}
        good, bad = by_id["t0000"], by_id["t0001"]
        assert good["status"] == "SUCCEEDED"
        assert bad["status"] == "CANCELED"      # stopped while RUNNING
        assert out["best_config"]["lvl"] == 1.0


class TestProgressIncremental:
    def test_incr_read_consumes_only_complete_lines(self, tmp_path):
        from tosem_tpu_torch.tune.trial_worker import (read_progress,
                                                 read_progress_incr)
        p = str(tmp_path / "x.progress")
        with open(p, "w") as f:
            f.write('{"a": 1}\n{"a": 2}\n{"a": 3')   # torn tail
        got, off = read_progress_incr(p, 0)
        assert [m["a"] for m in got] == [1, 2]
        # the torn line is NOT consumed; completing it resumes there
        with open(p, "a") as f:
            f.write('}\n{"a": 4}\n')
        got2, off2 = read_progress_incr(p, off)
        assert [m["a"] for m in got2] == [3, 4] and off2 > off
        assert [m["a"] for m in read_progress(p)] == [1, 2, 3, 4]
