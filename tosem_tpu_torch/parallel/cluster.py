"""Local multi-process cluster fixture.

Counterpart of ``tosem_tpu/parallel/cluster.py``. :class:`LocalCluster`
starts N real OS processes on localhost, each a fresh interpreter
(``python -m tosem_tpu_torch.parallel.cluster_worker``: spawned, never
forked, since a forked child of a process that touched CUDA cannot take
a card). Each child hides the cards (``CUDA_VISIBLE_DEVICES=``, as the
JAX package's children force its CPU platform), joins a gloo process
group through :func:`~tosem_tpu_torch.parallel.mesh.multihost_init`'s
real branch, with a time limit on every collective so the survivors of a
killed rank raise instead of hanging, and runs a job named
``"module:function"`` over a mesh of ``devices_per_process`` CPU
positions a process (:func:`~tosem_tpu_torch.parallel.jobs.
cluster_mesh`).

The parent process polls the children: when one dies it kills the rest
of the generation (they would block in a collective) and reports which
rank failed. Elastic recovery is relaunch from a checkpoint: a failed
generation is torn down and a fresh one restores the job's state from
the shared ``workdir``.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence


# every collective of a generation's process group gives up after this
# long, so the survivors of a killed rank raise instead of hanging
COLLECTIVE_TIMEOUT_S = 60.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class ClusterResult:
    ok: bool
    results: Dict[int, Any]          # process_id -> job return value
    failed: List[int]                # ranks that exited nonzero / were killed
    generation: int = 0
    restarts: int = 0


@dataclass
class LocalCluster:
    """N-process localhost topology, each process ``devices_per_process``
    CPU positions.

    Jobs are named ``"module:function"`` targets so child processes can
    import them. Each child writes its return value as JSON to
    ``workdir/result_<run>_g{gen}_p{rank}.json``.
    """

    num_processes: int = 2
    devices_per_process: int = 1
    workdir: Optional[str] = None
    extra_sys_path: Sequence[str] = field(default_factory=tuple)

    def __post_init__(self):
        if self.workdir is None:
            self.workdir = tempfile.mkdtemp(prefix="tosem_torch_cluster_")
        os.makedirs(self.workdir, exist_ok=True)
        self._procs: Dict[int, subprocess.Popen] = {}
        self._logs: List[Any] = []
        self._generation = -1
        # distinguishes this instance's artifacts when a caller-supplied
        # workdir is reused across LocalCluster instances
        self._run_id = uuid.uuid4().hex[:8]

    # -- lifecycle -----------------------------------------------------

    def start(self, target: str, kwargs: Optional[Dict[str, Any]] = None,
              env: Optional[Dict[str, str]] = None) -> None:
        """Launch one generation of ``num_processes`` workers."""
        if self._procs:
            raise RuntimeError("generation already running; stop() first")
        kwargs = dict(kwargs or {})
        if "workdir" in kwargs:
            raise ValueError("'workdir' is injected by the cluster; "
                             "jobs receive it automatically")
        self._generation += 1
        port = _free_port()
        spec = {
            "target": target,
            "kwargs": kwargs,
            "workdir": self.workdir,
            "run": f"{self._run_id}_g{self._generation}",
            "extra_sys_path": list(self.extra_sys_path),
            "positions": self.devices_per_process,
        }
        spec_path = os.path.join(
            self.workdir, f"spec_{self._run_id}_g{self._generation}.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        for rank in range(self.num_processes):
            child_env = dict(os.environ)
            child_env["PYTHONPATH"] = repo_root + os.pathsep + child_env.get(
                "PYTHONPATH", "")
            # the children run on the CPU: no card is visible to them
            child_env["CUDA_VISIBLE_DEVICES"] = ""
            child_env["COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
            child_env["NUM_PROCESSES"] = str(self.num_processes)
            child_env["PROCESS_ID"] = str(rank)
            child_env["TOSEM_CLUSTER_SPEC"] = spec_path
            child_env.update(env or {})
            log = open(os.path.join(
                self.workdir,
                f"log_{self._run_id}_g{self._generation}_p{rank}.txt"), "wb")
            self._logs.append(log)
            self._procs[rank] = subprocess.Popen(
                [sys.executable, "-m",
                 "tosem_tpu_torch.parallel.cluster_worker"],
                env=child_env, stdout=log, stderr=subprocess.STDOUT,
                cwd=self.workdir)

    def kill_process(self, rank: int, sig: int = signal.SIGKILL) -> None:
        """Simulated host failure."""
        p = self._procs.get(rank)
        if p is not None and p.poll() is None:
            p.send_signal(sig)

    def stop(self) -> None:
        for p in self._procs.values():
            if p.poll() is None:
                p.kill()
        for p in self._procs.values():
            p.wait()
        self._procs.clear()
        for log in self._logs:
            log.close()
        self._logs.clear()

    # -- driving -------------------------------------------------------

    def wait(self, timeout: float = 180.0) -> ClusterResult:
        """Block until the generation finishes or a worker dies: a
        nonzero child exit fails the generation at once, and the
        survivors are killed rather than left blocking in a collective
        waiting on a dead peer."""
        deadline = time.monotonic() + timeout
        failed: List[int] = []
        live = dict(self._procs)
        while live and time.monotonic() < deadline:
            for rank, p in list(live.items()):
                rc = p.poll()
                if rc is None:
                    continue
                del live[rank]
                if rc != 0:
                    failed.append(rank)
            if failed:
                break
            time.sleep(0.05)
        if live and not failed:       # timed out
            failed.extend(live.keys())
        self.stop()
        results: Dict[int, Any] = {}
        for rank in range(self.num_processes):
            path = os.path.join(
                self.workdir,
                f"result_{self._run_id}_g{self._generation}_p{rank}.json")
            if os.path.exists(path):
                with open(path) as f:
                    results[rank] = json.load(f)
        ok = not failed and len(results) == self.num_processes
        return ClusterResult(ok=ok, results=results, failed=sorted(failed),
                             generation=self._generation)

    def run(self, target: str, kwargs: Optional[Dict[str, Any]] = None,
            timeout: float = 180.0) -> ClusterResult:
        self.start(target, kwargs)
        return self.wait(timeout)

    def run_elastic(self, target: str,
                    kwargs: Optional[Dict[str, Any]] = None,
                    max_restarts: int = 1,
                    timeout: float = 180.0) -> ClusterResult:
        """Relaunch-from-checkpoint recovery: on a failed generation, tear
        down and start a fresh one; the job restores its own state from
        ``workdir``."""
        restarts = 0
        while True:
            res = self.run(target, kwargs, timeout)
            res.restarts = restarts
            if res.ok or restarts >= max_restarts:
                return res
            restarts += 1

    def log(self, rank: int, generation: Optional[int] = None) -> str:
        gen = self._generation if generation is None else generation
        path = os.path.join(
            self.workdir, f"log_{self._run_id}_g{gen}_p{rank}.txt")
        if not os.path.exists(path):
            return ""
        with open(path, errors="replace") as f:
            return f.read()
