"""Remote-machine bootstrap — the SSH-shaped training-service leg.

The reference's remote training service does three things our
:class:`~tosem_tpu_torch.tune.providers.NodeAgentService` assumed away: it
STARTS the remote environment itself over a shell transport, waits for
it to come up, and tears it down afterwards
(``ts/nni_manager/training_service/remote_machine/
remoteMachineTrainingService.ts`` driving ``shellExecutor.ts``). This
module supplies that leg:

- :class:`CommandRunner` — the ``shellExecutor`` seam: run one shell
  command, hand back the process. :class:`LocalRunner` executes on this
  host (the ``ssh localhost`` stand-in CI uses); :class:`SshRunner`
  wraps the command in ``ssh -o BatchMode=yes host``. Tests inject a
  recording fake — the transport is fully mockable.
- :func:`bootstrap_agent` — launch a node agent THROUGH a runner, read
  its announced ``host:port`` off the transport's stdout (bounded), and
  connect a :class:`~tosem_tpu_torch.cluster.node.RemoteNode` to it. No code
  upload step: the repo is the environment (the reference rsyncs a
  codeDir; our agents import by PYTHONPATH).
- :class:`BootstrapService` — a
  :class:`~tosem_tpu_torch.tune.providers.TrainingService` that
  bootstraps its agents on construction and tears them down in
  ``shutdown()``, with trials delegated to the agent trial plane
  (killable mid-flight).

Cross-host reach note: agents bind loopback by design (`cluster/rpc.py`
refuses public binds — the control plane is unauthenticated pickle), so
a real multi-host deployment runs ``SshRunner`` with an ``ssh -L`` port
forward per agent, exactly like the reference tunnels its gRPC channel.

A copy of the JAX package's ``cluster/bootstrap.py``.
"""
from __future__ import annotations

import os
import select
import shlex
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from tosem_tpu_torch.cluster.node import RemoteNode

__all__ = ["CommandRunner", "LocalRunner", "SshRunner",
           "bootstrap_agent", "BootstrappedAgent", "BootstrapService",
           "ElasticAgentPool"]


class CommandRunner:
    """The shellExecutor seam: run one shell command, return the Popen.
    ``host`` is where the command's sockets are reachable."""

    host = "127.0.0.1"

    def popen(self, command: str) -> subprocess.Popen:
        raise NotImplementedError


class LocalRunner(CommandRunner):
    """Execute on this host — CI's ``ssh localhost`` stand-in."""

    def popen(self, command: str) -> subprocess.Popen:
        return subprocess.Popen(["bash", "-c", command],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL)


class SshRunner(CommandRunner):
    """Execute over ssh (BatchMode: key auth only, never an interactive
    prompt wedging the manager — the reference's non-interactive
    contract)."""

    def __init__(self, host: str, user: Optional[str] = None,
                 ssh_options: Sequence[str] = ()):
        self.host = host
        self._dest = f"{user}@{host}" if user else host
        self._opts = list(ssh_options)

    def popen(self, command: str) -> subprocess.Popen:
        return subprocess.Popen(
            ["ssh", "-o", "BatchMode=yes", *self._opts, self._dest,
             command],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)


class BootstrappedAgent:
    """A node agent this manager started and therefore owns."""

    def __init__(self, node: RemoteNode, proc: subprocess.Popen):
        self.node = node
        self._proc = proc

    def teardown(self) -> None:
        self.node.close()
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()


def _agent_command(num_workers: int, extra_sys_path: Sequence[str],
                   python: str) -> str:
    """One shell line that boots a node agent announcing on stdout.
    PYTHONPATH rides inside the command — ssh does not forward env."""
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    path = os.pathsep.join([repo_root, *extra_sys_path])
    args = " ".join(
        ["--num-workers", str(num_workers)]
        + [a for p in extra_sys_path for a in ("--path", shlex.quote(p))])
    return (f"PYTHONPATH={shlex.quote(path)} exec {shlex.quote(python)} "
            f"-c 'from tosem_tpu_torch.cluster.node import main; main()' "
            f"{args}")


def bootstrap_agent(runner: CommandRunner, *, num_workers: int = 2,
                    extra_sys_path: Sequence[str] = (),
                    python: str = sys.executable,
                    startup_timeout: float = 60.0) -> BootstrappedAgent:
    """Start a node agent through ``runner`` and connect to it.

    Reads the agent's ``host:port`` announcement from the transport's
    stdout with a bounded wait (a wedged remote python must not hang the
    manager), then rewrites the host to the runner's reachable address.
    """
    proc = runner.popen(_agent_command(num_workers, extra_sys_path,
                                       python))
    fd = proc.stdout.fileno()
    line = b""
    deadline = time.monotonic() + startup_timeout
    while not line.endswith(b"\n"):
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        ready, _, _ = select.select([fd], [], [], remaining)
        if not ready:
            break
        chunk = os.read(fd, 256)
        if not chunk:
            break                        # EOF: remote died pre-announce
        line += chunk
    if not line.endswith(b"\n"):
        proc.kill()
        raise RuntimeError(
            f"agent failed to announce via {type(runner).__name__} "
            f"within {startup_timeout}s")
    _, _, port = line.decode().strip().rpartition(":")
    node = RemoteNode(f"{runner.host}:{port}")
    return BootstrappedAgent(node, proc)


class ElasticAgentPool:
    """Node-level elasticity over the shell transport — the reference
    autoscaler's node-launcher half (``python/ray/autoscaler/``:
    demand converts into NODE launches, idle nodes terminate). Here a
    "node launch" is :func:`bootstrap_agent` through a
    :class:`CommandRunner` factory, and the pool's hooks plug straight
    into :class:`~tosem_tpu_torch.cluster.autoscaler.Autoscaler`
    (``stats_fn``/``add_fn``/``remove_fn``), so ONE scaling policy
    drives in-process workers and whole agents alike.

    ``nodes`` is a LIVE list (mutated in place): hand it to a
    :class:`~tosem_tpu_torch.tune.providers.NodeAgentService` and newly
    launched agents join the round-robin immediately.
    """

    def __init__(self, runner_factory: Callable[[], CommandRunner], *,
                 num_workers: int = 1, min_agents: int = 1,
                 max_agents: int = 4,
                 extra_sys_path: Sequence[str] = (),
                 demand_fn: Optional[Callable[[], int]] = None,
                 startup_timeout: float = 60.0):
        self._factory = runner_factory
        self._num_workers = num_workers
        self.min_agents, self.max_agents = min_agents, max_agents
        self._extra = list(extra_sys_path)
        self._timeout = startup_timeout
        self._demand = demand_fn or (lambda: 0)
        # protects agents/nodes against the Autoscaler.run() monitor
        # thread racing the owner's shutdown()/stats(). NOTE: the
        # scale_down idle check remains check-then-act against a
        # concurrently dispatching service — downscale with the service
        # quiesced, or accept the (bounded) chance of killing a trial
        # admitted in that window.
        self._lock = threading.Lock()
        self._closed = False
        self.agents: List[BootstrappedAgent] = []
        self.nodes: List[RemoteNode] = []     # live view for services
        try:
            for _ in range(min_agents):
                self.scale_up()
        except Exception:
            self.shutdown()              # no half-bootstrapped leak
            raise

    # -- autoscaler hooks ----------------------------------------------

    def stats(self) -> Dict[str, int]:
        """Demand view in the Autoscaler's vocabulary: each agent slot
        is a 'worker', backlog is the caller-supplied trial demand,
        inflight is the agents' active trials."""
        with self._lock:
            nodes = list(self.nodes)
            n_agents = len(self.agents)
        inflight = 0
        for node in nodes:
            try:
                inflight += int(node.stats().get("active_trials", 0))
            except Exception:
                pass                        # a dying agent reads as idle
        # report TRUE capacity — a phantom worker at zero agents would
        # make `backlog > per_worker * workers` unreachable and starve
        # scale-up from empty
        return {"num_workers": n_agents,
                "pending": int(self._demand()),
                "inflight": inflight}

    def scale_up(self) -> int:
        with self._lock:
            if self._closed or len(self.agents) >= self.max_agents:
                return len(self.agents)
        agent = bootstrap_agent(self._factory(),
                                num_workers=self._num_workers,
                                extra_sys_path=self._extra,
                                startup_timeout=self._timeout)
        with self._lock:
            if self._closed:             # lost the race with shutdown
                agent.teardown()
                return 0
            self.agents.append(agent)
            self.nodes.append(agent.node)
            return len(self.agents)

    def scale_down(self) -> bool:
        """Tear down ONE idle agent (newest first), never below
        ``min_agents`` and never one with live trials — the idle-node
        terminate rule."""
        with self._lock:
            if len(self.agents) <= self.min_agents:
                return False
            candidates = list(enumerate(self.agents))
        victim = None
        for i, agent in reversed(candidates):
            try:
                if int(agent.node.stats().get("active_trials", 0)):
                    continue
            except Exception:
                pass                        # unreachable: reap it
            victim = (i, agent)
            break
        if victim is None:
            return False
        i, agent = victim
        with self._lock:
            if i < len(self.agents) and self.agents[i] is agent:
                del self.agents[i]
                del self.nodes[i]
            else:
                return False             # list changed under us
        agent.teardown()
        return True

    def shutdown(self) -> None:
        with self._lock:
            self._closed = True
            agents = list(self.agents)
            self.agents = []
            del self.nodes[:]
        for a in agents:
            try:
                a.teardown()
            except Exception:
                pass


class BootstrapService:
    """TrainingService that owns its agents' lifecycle: bootstrap over
    shell transports at construction, run trials on the agents' killable
    trial plane, tear everything down in ``shutdown()`` — the
    remoteMachineTrainingService contract end to end."""

    def __init__(self, runners: Sequence[CommandRunner], *,
                 num_workers: int = 2,
                 extra_sys_path: Sequence[str] = (),
                 max_concurrent: int = 4,
                 startup_timeout: float = 60.0):
        from tosem_tpu_torch.tune.providers import NodeAgentService
        self._agents: List[BootstrappedAgent] = []
        try:
            for r in runners:
                self._agents.append(bootstrap_agent(
                    r, num_workers=num_workers,
                    extra_sys_path=extra_sys_path,
                    startup_timeout=startup_timeout))
        except Exception:
            self.shutdown()              # no half-bootstrapped leak
            raise
        self._inner = NodeAgentService(
            [a.node for a in self._agents], max_concurrent=max_concurrent)

    # -- TrainingService delegation ------------------------------------

    def submit(self, trainable_ref: str, config: Dict[str, Any],
               trial_id: str, max_iterations: int) -> None:
        self._inner.submit(trainable_ref, config, trial_id,
                           max_iterations)

    def poll(self):
        return self._inner.poll()

    def cancel(self, trial_id: str) -> None:
        self._inner.cancel(trial_id)

    def shutdown(self) -> None:
        inner = getattr(self, "_inner", None)
        if inner is not None:
            inner.shutdown()
        for a in self._agents:
            try:
                a.teardown()
            except Exception:
                pass
        self._agents = []
