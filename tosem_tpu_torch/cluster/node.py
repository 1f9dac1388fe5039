"""Node agent — the per-host daemon of the cross-host control plane.

The reference's raylet/node-manager answers driver RPCs to lease
workers, execute tasks, and report health (`src/ray/raylet/
node_manager.cc` + NodeManagerService). Here a :class:`NodeAgent` is a
standalone process hosting a spawn-mode process pool; the driver talks
to it through :class:`~tosem_tpu_torch.cluster.rpc.RpcClient` via
:class:`RemoteNode` (submit/map/health/stats), and
:func:`RemoteNode.spawn_local` boots one as a subprocess for tests and
single-box multi-daemon topologies (`cluster_utils` style). Functions
ship as pickled blobs, so the remote side needs the same code
importable — the multiprocessing-spawn contract, cluster-wide.

A copy of the JAX package's ``cluster/node.py``. The agent never imports
torch and never touches the card: its task pool is spawned, and each
serve replica and each trial (``start_trial``, a
``tosem_tpu_torch.tune.trial_worker`` process) is a fresh interpreter
that sees every card the agent's environment shows, and dies with the
agent (``die_with_parent``). A replica's ``devices`` is the number of
mesh positions it holds (all on its own device), so the slots its gang
withholds.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Callable, Dict, List, Optional

from tosem_tpu_torch.cluster.fencing import StaleEpochError, Watermark
from tosem_tpu_torch.cluster.rpc import RpcClient, RpcError, RpcServer


class NodeDrainingError(RuntimeError):
    """The node agent is draining (unhealthy or told to drain): it
    rejects new tasks/trials immediately instead of hanging callers.
    In-flight work is allowed to finish — graceful degradation, the
    raylet's drain-before-termination contract."""


def _run_blob(blob: bytes) -> bytes:
    fn, args, kwargs = pickle.loads(blob)
    return pickle.dumps(fn(*args, **kwargs))


def read_announce(fd: int, timeout: float) -> bytes:
    """Read one announce line ("host:port\\n") from a child's pipe,
    select-bounded so a wedged child (stuck import, bind deadlock)
    cannot block past ``timeout``. Closes ``fd``. Returns the raw line
    (possibly without its newline when the child died or timed out —
    callers check ``endswith(b"\\n")``). Shared by the agent bootstrap,
    the serve replica plane, and the router tier."""
    import select
    line = b""
    deadline = time.monotonic() + timeout
    try:
        while not line.endswith(b"\n"):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            ready, _, _ = select.select([fd], [], [], remaining)
            if not ready:
                break
            chunk = os.read(fd, 256)
            if not chunk:
                break                    # EOF: child died pre-announce
            line += chunk
    finally:
        os.close(fd)
    return line


# resolved at MODULE import, never inside preexec_fn: the fn runs in
# the forked child of a multithreaded parent, where an `import` can
# deadlock on the import lock another thread held at fork time
try:
    import ctypes as _ctypes
    _LIBC = _ctypes.CDLL("libc.so.6", use_errno=True)
except Exception:                # non-Linux: orphans are close()'s job
    _LIBC = None


def die_with_parent():
    """preexec_fn: SIGKILL this child when its parent dies (Linux
    PR_SET_PDEATHSIG). A node agent SIGKILLed by chaos (or a crashed
    driver) must take its replica/router children with it — on a real
    node death the machine is gone, and the single-host simulation has
    to match, or every bench/chaos run leaks orphan replica processes
    that still answer on their old ports. (Belt only — some sandbox
    kernels never deliver PDEATHSIG; the lifeline pipe is the
    suspenders.) Async-signal-safe by construction: no imports, no
    allocation-heavy work — just the prctl syscall."""
    if _LIBC is not None:
        try:
            _LIBC.prctl(1, 9)    # PR_SET_PDEATHSIG = 1, SIGKILL = 9
        except Exception:
            pass


def _exit_with_agent(agent_pid: int) -> None:
    """Initializer of the task pool's workers: exit when the agent does.
    A spawn-mode worker holds both ends of its call queue, so a killed
    agent would leave it blocked forever, reparented and alive (as the
    JAX package's workers are: ROADMAP.md C-ref12). PDEATHSIG, then a
    thread that watches the parent pid for the kernels that never
    deliver the signal."""
    import threading
    die_with_parent()

    def watch() -> None:
        while os.getppid() == agent_pid:
            time.sleep(1.0)
        os._exit(0)
    threading.Thread(target=watch, daemon=True,
                     name="tosem-agent-watch").start()


class _AgentHandlers:
    """RPC surface of one node (the NodeManagerService analog)."""

    def __init__(self, num_workers: int):
        import multiprocessing as mp
        import tempfile
        import threading
        self._pool = ProcessPoolExecutor(
            max_workers=num_workers, mp_context=mp.get_context("spawn"),
            initializer=_exit_with_agent, initargs=(os.getpid(),))
        self._num_workers = num_workers
        self._started = time.time()
        # connections are served on separate threads: count atomically
        self._done_lock = threading.Lock()
        self._tasks_done = 0
        # gang slots (placement-group bundles on this node): reserved
        # capacity is withheld from general tasks, and tasks tagged with
        # a group are admitted only up to its reservation
        self._adm = threading.Condition()
        self._reserved: Dict[str, int] = {}
        self._active_general = 0
        self._active_pg: Dict[str, int] = {}
        # the replicas' stderr files
        self._work_dir = tempfile.mkdtemp(prefix="agent_")
        # trial plane: subprocess-backed so a RUNNING trial is actually
        # killable (a pool future is not) — the remote training
        # service's cancelTrialJob contract
        self._trials: Dict[str, Dict[str, Any]] = {}
        self._trials_lock = threading.Lock()
        self._trial_dir = tempfile.mkdtemp(prefix="agent_trials_")
        # serve replica plane: long-lived backend processes this node
        # hosts for the cluster serving tier (each is its own RpcServer
        # the router tier talks to directly — the agent only does
        # lifecycle, like a raylet hosting replica workers)
        self._sreps: Dict[str, Dict[str, Any]] = {}
        self._sreps_lock = threading.Lock()
        # drain state: an unhealthy node stops taking new work but lets
        # in-flight work finish, so callers fail fast instead of hanging
        self._draining = False
        self._health_calls = 0
        # chaos seam (the agent is its own process, so faults ride env
        # vars): become unhealthy after N health() calls / answer
        # health() slowly — the two cluster-layer fault shapes
        self._chaos_unhealthy_after = int(
            os.environ.get("TOSEM_CHAOS_NODE_UNHEALTHY_AFTER", "0") or "0")
        self._chaos_slow_health_s = float(
            os.environ.get("TOSEM_CHAOS_SLOW_HEALTH_S", "0") or "0")
        # head-epoch watermark: replica lifecycle calls stamped with an
        # older head epoch than the highest seen are rejected typed — a
        # superseded head cannot place or stop replicas on this node
        self._epoch = Watermark()

    def fence(self, epoch: int) -> int:
        """Advance the agent's head-epoch watermark (monotonic; a
        recovered head fences every live agent it re-adopts)."""
        self._epoch.check(int(epoch), what="fence")
        return self._epoch.epoch

    def health(self) -> Dict[str, Any]:
        with self._adm:
            self._health_calls += 1
            if (self._chaos_unhealthy_after
                    and self._health_calls > self._chaos_unhealthy_after):
                self._draining = True
        if self._chaos_slow_health_s:
            time.sleep(self._chaos_slow_health_s)
        return {"ok": not self._draining, "draining": self._draining,
                "pid": os.getpid(),
                "uptime_s": time.time() - self._started}

    def drain(self) -> bool:
        """Stop admitting new work (idempotent). Health flips to
        ``ok=False`` so pool managers route around this node."""
        with self._adm:
            self._draining = True
            self._adm.notify_all()
        return True

    def stats(self) -> Dict[str, Any]:
        with self._adm:
            reserved = sum(self._reserved.values())
        with self._trials_lock:
            active_trials = sum(
                1 for t in self._trials.values()
                if t["status"] in ("WAITING", "RUNNING"))
        with self._sreps_lock:
            live = [r for r in self._sreps.values()
                    if r["proc"].poll() is None]
            # capacity metadata the placement layer plans against:
            # unsharded replicas weigh one slot; sharded (gang) replicas
            # hold their dp*tp slots through the task-plane reservation
            # their driver took, so they are NOT double-counted here
            replica_slots = sum(1 for r in live if not r["devices"])
        return {"num_workers": self._num_workers,
                "tasks_done": self._tasks_done,
                "reserved_slots": reserved,
                "free_slots": self._num_workers - reserved,
                "active_trials": active_trials,
                "replicas_active": len(live),
                "replica_slots_free": max(
                    0, self._num_workers - reserved - replica_slots)}

    # -- gang slots ----------------------------------------------------

    def reserve(self, pg: str, n: int) -> bool:
        """All-or-nothing reservation of ``n`` slots for group ``pg``.
        Idempotent per (pg): a second reserve for the same id replaces the
        first. Returns False (no partial state) when capacity is short."""
        if n <= 0:
            return False
        with self._adm:
            other = sum(v for k, v in self._reserved.items() if k != pg)
            if n > self._num_workers - other:
                return False
            self._reserved[pg] = n
            self._adm.notify_all()
            return True

    def release(self, pg: str) -> int:
        with self._adm:
            n = self._reserved.pop(pg, 0)
            self._adm.notify_all()
            return n

    def _admit(self, pg: Optional[str]) -> None:
        with self._adm:
            while True:
                if self._draining:
                    # fail fast, never hang: a draining node's callers
                    # get a typed rejection they can route around
                    raise NodeDrainingError(
                        "node agent is draining; rejecting new work")
                if pg is None:
                    free = self._num_workers - sum(self._reserved.values())
                    if self._active_general < free:
                        self._active_general += 1
                        return
                else:
                    cap = self._reserved.get(pg)
                    if cap is None:
                        raise KeyError(
                            f"no reservation for placement group {pg!r} "
                            "on this node")
                    if self._active_pg.get(pg, 0) < cap:
                        self._active_pg[pg] = self._active_pg.get(pg, 0) + 1
                        return
                self._adm.wait(1.0)

    def _leave(self, pg: Optional[str]) -> None:
        with self._adm:
            if pg is None:
                self._active_general -= 1
            else:
                self._active_pg[pg] = self._active_pg.get(pg, 1) - 1
            self._adm.notify_all()

    # -- task plane ----------------------------------------------------

    def run_task(self, blob: bytes, pg: Optional[str] = None) -> bytes:
        self._admit(pg)
        try:
            out = self._pool.submit(_run_blob, blob).result()
        finally:
            self._leave(pg)
        with self._done_lock:
            self._tasks_done += 1
        return out

    def run_batch(self, blobs: List[bytes],
                  pg: Optional[str] = None) -> List[bytes]:
        # each task's slot frees as ITS future completes (done-callback),
        # never after the whole batch — admitting a batch larger than the
        # pool up-front with one bulk release would deadlock the admission
        futs = []
        for b in blobs:
            self._admit(pg)
            fut = self._pool.submit(_run_blob, b)
            fut.add_done_callback(lambda _f, pg=pg: self._leave(pg))
            futs.append(fut)
        outs = [f.result() for f in futs]
        with self._done_lock:
            self._tasks_done += len(outs)
        return outs

    # -- trial plane (remote training service) -------------------------

    def start_trial(self, task_id: str, trainable_ref: str,
                    config_json: str, max_iterations: int,
                    pg: Optional[str] = None,
                    checkpoint_freq: int = 5,
                    checkpoint_dir: Optional[str] = None) -> None:
        """Launch a trial as a dedicated killable subprocess. Returns
        immediately; admission (the agent's slot gate) happens on a
        background thread, so a full node queues the trial rather than
        blocking the RPC. ``checkpoint_dir`` overrides the agent-local
        trial dir for the checkpoint file — point it at shared storage
        and a trial resubmitted on ANOTHER node resumes from the same
        checkpoint (cross-node crash-resume)."""
        import threading
        with self._trials_lock:
            prior = self._trials.get(task_id)
            if prior is not None and prior["status"] not in ("FAILED",
                                                             "CANCELED"):
                raise ValueError(f"trial {task_id!r} already exists")
            # resubmitting a FAILED/CANCELED id relaunches it against
            # the same checkpoint file — crash-resume, not restart
            # (class trainables pick up at their last checkpoint)
            t = {"status": "WAITING", "proc": None, "error": "",
                 "killed": False}
            if prior is not None:
                t["prog_off"] = prior.get("prog_off", 0)
                t["prog_cache"] = prior.get("prog_cache", [])
            self._trials[task_id] = t

        out = os.path.join(self._trial_dir, f"{task_id}.json")
        progress = os.path.join(self._trial_dir, f"{task_id}.progress")
        errp = os.path.join(self._trial_dir, f"{task_id}.err")

        def work():
            from tosem_tpu_torch.tune.trial_worker import worker_argv
            admitted = False
            try:
                # inside the guard: an admission failure (e.g. the gang
                # reservation was released while this trial queued) must
                # fail the trial, not strand it in WAITING
                self._admit(pg)
                admitted = True
                with self._trials_lock:
                    if t["killed"]:
                        t["status"] = "CANCELED"
                        return
                    env = dict(os.environ)
                    # the agent's sys.path (repo root + --path extras)
                    # must reach the child, or the trainable is not
                    # importable there
                    env["PYTHONPATH"] = os.pathsep.join(
                        [p for p in sys.path if p])
                    errf = open(errp, "wb")
                    if checkpoint_dir:
                        os.makedirs(checkpoint_dir, exist_ok=True)
                        ckpt = os.path.join(checkpoint_dir,
                                            f"{task_id}.ckpt")
                    else:
                        ckpt = os.path.join(self._trial_dir,
                                            f"{task_id}.ckpt")
                    t["proc"] = subprocess.Popen(
                        worker_argv(trainable_ref, config_json,
                                    max_iterations, out, progress,
                                    checkpoint_path=ckpt,
                                    checkpoint_freq=checkpoint_freq),
                        env=env, stdout=subprocess.DEVNULL, stderr=errf,
                        preexec_fn=die_with_parent)
                    errf.close()
                    t["status"] = "RUNNING"
                rc = t["proc"].wait()
                with self._trials_lock:
                    if t["killed"]:
                        t["status"] = "CANCELED"
                    elif rc == 0 and os.path.exists(out):
                        t["status"] = "SUCCEEDED"
                    else:
                        err = b""
                        if os.path.exists(errp):
                            with open(errp, "rb") as f:
                                err = f.read()
                        t["error"] = (f"rc={rc}: "
                                      f"{err[-500:].decode(errors='replace')}")
                        t["status"] = "FAILED"
            except BaseException as e:
                # a spawn/admission failure must not strand the trial in
                # WAITING with no diagnostic
                with self._trials_lock:
                    t["error"] = repr(e)
                    t["status"] = "FAILED"
            finally:
                if admitted:
                    self._leave(pg)
                with self._done_lock:
                    self._tasks_done += 1

        threading.Thread(target=work, daemon=True,
                         name=f"trial-{task_id}").start()

    def trial_status(self, task_id: str,
                     since: int = 0) -> Dict[str, Any]:
        """Status + metrics (final result file when done, else the
        progress stream — the intermediate-result side channel).
        ``since`` slices the returned metrics (the caller's count of
        already-received reports) so a poll loop ships only the new
        suffix; the agent itself reads the progress file incrementally
        via a cached byte offset — O(new lines) on both sides."""
        with self._trials_lock:
            t = self._trials.get(task_id)
            if t is None:
                raise KeyError(f"unknown trial {task_id!r}")
            status, error = t["status"], t["error"]
        from tosem_tpu_torch.tune.trial_worker import read_progress_incr
        out = os.path.join(self._trial_dir, f"{task_id}.json")
        if status == "SUCCEEDED" and os.path.exists(out):
            import json
            with open(out) as f:
                metrics = json.load(f)["metrics"]
        else:
            with self._trials_lock:
                new, off = read_progress_incr(
                    os.path.join(self._trial_dir,
                                 f"{task_id}.progress"),
                    t.get("prog_off", 0))
                t["prog_off"] = off
                t.setdefault("prog_cache", []).extend(new)
                metrics = list(t["prog_cache"])
        return {"status": status, "metrics": metrics[since:],
                "n_total": len(metrics), "error": error}

    def kill_trial(self, task_id: str) -> bool:
        """Cancel a trial in ANY live state: a WAITING one never starts,
        a RUNNING one's subprocess is killed (partial metrics survive in
        the progress file)."""
        with self._trials_lock:
            t = self._trials.get(task_id)
            if t is None:
                raise KeyError(f"unknown trial {task_id!r}")
            if t["status"] in ("SUCCEEDED", "FAILED", "CANCELED"):
                return False
            t["killed"] = True
            proc = t["proc"]
            if t["status"] == "WAITING":
                t["status"] = "CANCELED"
        if proc is not None and proc.poll() is None:
            proc.kill()
        return True

    # -- serve replica plane --------------------------------------------

    def start_replica(self, replica_id: str, backend_ref: str,
                      init_kwargs_json: str = "{}", devices: int = 0,
                      startup_timeout: float = 120.0,
                      epoch: Optional[int] = None) -> str:
        """Spawn a long-lived serve replica process hosting
        ``backend_ref`` ("module:qualname") and return its RPC address.
        Idempotent per id while the process lives (a re-placement retry
        must not leak a second process). ``devices`` > 0 is the number of
        mesh positions a sharded replica holds (its dp*tp, all on the
        replica's own device); the agent only records it, and hides no
        card from the replica. ``epoch`` is the placing head's fencing
        epoch: stale (a superseded head) is rejected typed before
        anything spawns."""
        self._epoch.check(epoch, what="start_replica")
        if self._draining:
            raise NodeDrainingError(
                "node agent is draining; rejecting new replicas")
        with self._sreps_lock:
            prior = self._sreps.pop(replica_id, None)
            if prior is not None and prior["proc"].poll() is None:
                self._sreps[replica_id] = prior
                return prior["address"]
        if prior is not None:
            # dead prior under the same id: its lifeline write end is
            # ours to close, or crash/re-place cycles leak one fd each
            try:
                os.close(prior["lifeline"])
            except OSError:
                pass
        env = dict(os.environ)
        # the agent's sys.path (repo root + --path extras) must reach
        # the replica, or the backend is not importable there
        env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
        errp = os.path.join(self._work_dir, f"rep_{replica_id}.err")
        r, w = os.pipe()
        # lifeline: the replica blocks on the read end; THIS process
        # holds the write end, so the replica exits on our death
        # however it happens (SIGKILL included — PDEATHSIG alone is
        # not deliverable on every kernel this runs under)
        life_r, life_w = os.pipe()
        with open(errp, "wb") as errf:
            proc = subprocess.Popen(
                [sys.executable, "-c",
                 "from tosem_tpu_torch.serve.replica_worker import main; "
                 "main()",
                 "--backend", backend_ref,
                 "--init-kwargs", init_kwargs_json,
                 "--announce-fd", str(w),
                 "--lifeline-fd", str(life_r)],
                pass_fds=(w, life_r), env=env,
                preexec_fn=die_with_parent,
                stdout=subprocess.DEVNULL, stderr=errf)
        os.close(w)
        os.close(life_r)
        line = read_announce(r, startup_timeout)
        if not line.endswith(b"\n"):
            proc.kill()
            proc.wait()
            os.close(life_w)
            err = b""
            if os.path.exists(errp):
                with open(errp, "rb") as f:
                    err = f.read()
            raise RuntimeError(
                f"replica {replica_id!r} failed to announce within "
                f"{startup_timeout}s: {err[-500:].decode(errors='replace')}")
        address = line.decode().strip()
        with self._sreps_lock:
            self._sreps[replica_id] = {"proc": proc, "address": address,
                                       "devices": int(devices),
                                       "backend_ref": backend_ref,
                                       "lifeline": life_w}
        return address

    def stop_replica(self, replica_id: str,
                     epoch: Optional[int] = None) -> bool:
        self._epoch.check(epoch, what="stop_replica")
        with self._sreps_lock:
            rec = self._sreps.pop(replica_id, None)
        if rec is None:
            return False
        if rec["proc"].poll() is None:
            rec["proc"].kill()
            rec["proc"].wait()
        try:
            os.close(rec["lifeline"])
        except OSError:
            pass
        return True

    def list_replicas(self) -> Dict[str, Dict[str, Any]]:
        """Live view of the replicas this node hosts — what a recovered
        head asks to re-adopt placements that survived its own crash."""
        with self._sreps_lock:
            return {rid: {"address": r["address"],
                          "alive": r["proc"].poll() is None,
                          "devices": r["devices"],
                          "backend_ref": r["backend_ref"]}
                    for rid, r in self._sreps.items()}

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
        with self._trials_lock:
            procs = [t["proc"] for t in self._trials.values()
                     if t["proc"] is not None]
        with self._sreps_lock:
            procs += [r["proc"] for r in self._sreps.values()]
            lifelines = [r["lifeline"] for r in self._sreps.values()]
            self._sreps.clear()
        for p in procs:
            if p.poll() is None:
                p.kill()
        for fd in lifelines:
            try:
                os.close(fd)
            except OSError:
                pass
        import shutil
        shutil.rmtree(self._work_dir, ignore_errors=True)
        shutil.rmtree(self._trial_dir, ignore_errors=True)


def serve(port: int = 0, num_workers: int = 2,
          announce_fd: Optional[int] = None,
          extra_sys_path: Optional[List[str]] = None) -> None:
    """Run a node agent until killed (the daemon entry point).
    ``extra_sys_path`` makes caller code importable here and in the
    spawn-mode pool workers (multiprocessing forwards sys.path)."""
    for p in extra_sys_path or []:
        if p not in sys.path:
            sys.path.insert(0, p)
    handlers = _AgentHandlers(num_workers)
    server = RpcServer(handlers, port=port)
    line = f"{server.address}\n".encode()
    if announce_fd is not None:
        os.write(announce_fd, line)
        os.close(announce_fd)
    else:
        sys.stdout.write(line.decode())
        sys.stdout.flush()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        handlers.close()


class RemoteNode:
    """Driver-side handle to a node agent."""

    def __init__(self, address: str, timeout: float = 60.0):
        self.address = address
        # unbounded call timeout: remote tasks may legitimately run long
        self._client = RpcClient(address, timeout=timeout)
        self._proc: Optional[subprocess.Popen] = None

    # -- control plane -------------------------------------------------

    def health(self) -> Dict[str, Any]:
        return self._client.call("health")

    def stats(self) -> Dict[str, Any]:
        return self._client.call("stats")

    def drain(self) -> bool:
        """Tell the agent to stop admitting new work (idempotent)."""
        return bool(self._client.call("drain"))

    @staticmethod
    def _translate(e: RpcError) -> BaseException:
        """Re-type a remote drain/fence rejection so callers can catch
        it without string-matching RpcError themselves. The RPC layer
        ships ``repr(exc)`` of the handler's exception, so a real
        drain rejection is exactly ``NodeDrainingError(...)`` at the
        START of the message — a substring match would misclassify an
        application error that merely *mentions* the name."""
        if str(e).startswith("NodeDrainingError("):
            return NodeDrainingError(str(e))
        if str(e).startswith("StaleEpochError("):
            return StaleEpochError(str(e))
        return e

    def fence(self, epoch: int) -> int:
        """Advance the agent's head-epoch watermark (what a recovered
        head does to every live agent it re-adopts)."""
        try:
            return int(self._client.call("fence", int(epoch)))
        except RpcError as e:
            raise self._translate(e) from None

    def alive(self, timeout: float = 5.0) -> bool:
        # a bounded, independent probe connection: a long task holding
        # the main client's lock (or a wedged agent) must not make the
        # liveness check hang or lie
        try:
            with RpcClient(self.address, timeout=timeout,
                           call_timeout=timeout) as probe:
                return bool(probe.call("health").get("ok"))
        except Exception:
            return False

    # -- gang slots ----------------------------------------------------

    def reserve(self, pg: str, n: int) -> bool:
        """All-or-nothing reservation of ``n`` slots on this node."""
        return bool(self._client.call("reserve", pg, n))

    def release(self, pg: str) -> int:
        return int(self._client.call("release", pg))

    # -- data plane ----------------------------------------------------

    def submit(self, fn: Callable, *args, **kwargs) -> Any:
        pg = kwargs.pop("_pg", None)
        blob = pickle.dumps((fn, args, kwargs))
        try:
            if pg is not None:
                return pickle.loads(self._client.call("run_task", blob, pg))
            return pickle.loads(self._client.call("run_task", blob))
        except RpcError as e:
            raise self._translate(e) from None

    def map(self, fn: Callable, items) -> List[Any]:
        blobs = [pickle.dumps((fn, (it,), {})) for it in items]
        try:
            return [pickle.loads(b)
                    for b in self._client.call("run_batch", blobs)]
        except RpcError as e:
            raise self._translate(e) from None

    # -- trial plane ---------------------------------------------------

    def start_trial(self, task_id: str, trainable_ref: str,
                    config: Dict[str, Any], max_iterations: int,
                    pg: Optional[str] = None,
                    checkpoint_freq: int = 5,
                    checkpoint_dir: Optional[str] = None) -> None:
        import json
        self._client.call("start_trial", task_id, trainable_ref,
                          json.dumps(config), max_iterations, pg,
                          checkpoint_freq, checkpoint_dir)

    def trial_status(self, task_id: str,
                     since: int = 0) -> Dict[str, Any]:
        return self._client.call("trial_status", task_id, since)

    def kill_trial(self, task_id: str) -> bool:
        return bool(self._client.call("kill_trial", task_id))

    # -- serve replica plane -------------------------------------------

    def start_replica(self, replica_id: str, backend_ref: str,
                      init_kwargs: Optional[Dict[str, Any]] = None,
                      devices: int = 0,
                      startup_timeout: float = 120.0,
                      epoch: Optional[int] = None) -> str:
        """Host a serve replica on this node; returns its RPC address.
        ``epoch`` stamps the placing head's fencing epoch (stale heads
        are rejected typed — :class:`StaleEpochError`)."""
        import json
        try:
            return str(self._client.call(
                "start_replica", replica_id, backend_ref,
                json.dumps(init_kwargs or {}), devices, startup_timeout,
                epoch))
        except RpcError as e:
            raise self._translate(e) from None

    def stop_replica(self, replica_id: str,
                     epoch: Optional[int] = None) -> bool:
        try:
            return bool(self._client.call("stop_replica", replica_id,
                                          epoch))
        except RpcError as e:
            raise self._translate(e) from None

    def list_replicas(self) -> Dict[str, Dict[str, Any]]:
        return self._client.call("list_replicas")

    # -- lifecycle -----------------------------------------------------

    @classmethod
    def spawn_local(cls, num_workers: int = 2,
                    startup_timeout: float = 60.0,
                    extra_sys_path: Optional[List[str]] = None
                    ) -> "RemoteNode":
        """Boot an agent subprocess on this host and connect to it."""
        r, w = os.pipe()
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get(
            "PYTHONPATH", "")
        path_args = []
        for p in extra_sys_path or []:
            path_args += ["--path", p]
        # -c (not -m): runpy re-executing an already-imported module
        # warns and can double-run module state
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "from tosem_tpu_torch.cluster.node import main; main()",
             "--num-workers", str(num_workers), "--announce-fd", str(w),
             *path_args],
            pass_fds=(w,), env=env)
        os.close(w)
        # select-bounded read: a wedged child (stuck import, bind
        # deadlock) must not block past startup_timeout
        line = read_announce(r, startup_timeout)
        if not line.endswith(b"\n"):
            proc.kill()
            proc.wait()
            raise RuntimeError("node agent failed to announce its address "
                               f"within {startup_timeout}s")
        node = cls(line.decode().strip())
        node._proc = proc
        return node

    def kill(self) -> None:
        """Simulated node failure."""
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        self._client.close()

    def close(self) -> None:
        self._client.close()
        if self._proc is not None and self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    port, num_workers, announce_fd = 0, 2, None
    paths: List[str] = []
    i = 0
    while i < len(args):
        if args[i] == "--port":
            port = int(args[i + 1]); i += 2
        elif args[i] == "--num-workers":
            num_workers = int(args[i + 1]); i += 2
        elif args[i] == "--announce-fd":
            announce_fd = int(args[i + 1]); i += 2
        elif args[i] == "--path":
            paths.append(args[i + 1]); i += 2
        else:
            print(f"unknown arg {args[i]}", file=sys.stderr)
            return 2
    serve(port=port, num_workers=num_workers, announce_fd=announce_fd,
          extra_sys_path=paths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
