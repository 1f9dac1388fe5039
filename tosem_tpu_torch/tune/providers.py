"""Pluggable training services — WHERE trials run.

The reference's NNI manager dispatches trial jobs through a
TrainingService interface with interchangeable backends (``ts/
nni_manager/training_service/``: local, remote, kubernetes,
``reusable/trialDispatcher.ts``); Ray's autoscaler has the same
provider shape for nodes (``python/ray/autoscaler/_private/
autoscaler.py:45``). The experiment layer here gains that seam:

- :class:`TrainingService` — submit / poll / cancel / shutdown.
- :class:`LocalService` — threads in this process (the quick default).
- :class:`SubprocessService` — one OS process per trial with a JSON
  result file (process isolation, the local-training-service contract).
- :class:`NodeAgentService` — trials dispatched to
  :class:`~tosem_tpu_torch.cluster.node.RemoteNode` agents over the RPC
  control plane: a genuinely remote (other-host) provider.

Every service runs the same trial protocol (generator/Trainable yielding
metric dicts, see :func:`run_trial`), so the manager loop
(:func:`run_with_service`) is provider-agnostic — the NNI property the
VERDICT calls the "provider-shaped interface".

The port's copy of ``tosem_tpu/tune/providers.py``. A trial process is a
fresh interpreter (``python -m tosem_tpu_torch.tune.trial_worker``),
never a forked child, so a trainable may take the card; the service
hides no device from it. Each row of :func:`run_with_service` also
carries ``iterations``, the reports the manager received, which the
experiment layer persists (the JAX package's rows lack it, so its
``hpo_cli results`` raises ``KeyError`` after a service run).
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

WAITING, RUNNING, SUCCEEDED, FAILED, CANCELED = (
    "WAITING", "RUNNING", "SUCCEEDED", "FAILED", "CANCELED")


def resolve_target(ref: str):
    mod, _, attr = ref.partition(":")
    if not attr:
        raise ValueError(f"trainable must be 'module:attr', got {ref!r}")
    return getattr(importlib.import_module(mod), attr)


def run_trial(trainable_ref: str, config: Dict[str, Any],
              max_iterations: int, *, metrics_cb=None,
              should_stop=None, checkpoint_path: Optional[str] = None,
              checkpoint_freq: int = 5) -> Dict[str, Any]:
    """Execute one trial; returns {metrics: [...]}. Shared by every
    service so placement never changes semantics.

    ``metrics_cb(m)`` streams each report as it lands (the NNI
    ``nni.report_intermediate_result`` side channel) and
    ``should_stop()`` is checked between iterations — the cooperative
    cancellation point that lets a manager early-stop a RUNNING trial
    (``cancelTrialJob`` on a live job, ``nnimanager.ts:633``).

    ``checkpoint_path`` enables crash-resume for **class** trainables
    (the ``save_state``/``load_state`` contract): every
    ``checkpoint_freq`` iterations the (iteration, state, metrics)
    triple is written atomically; a relaunched trial pointed at the
    same path resumes from the last checkpoint instead of restarting,
    with the pre-crash metric history restored into the final result
    (restored entries are NOT re-streamed through ``metrics_cb`` — they
    already went out before the crash). Generator trainables have no
    state contract, so they always restart."""
    import inspect
    import pickle as _pickle

    target = resolve_target(trainable_ref)
    metrics: List[Dict[str, Any]] = []

    def record(m: Dict[str, Any], i: int) -> None:
        m["training_iteration"] = i + 1
        metrics.append(m)
        if metrics_cb is not None:
            metrics_cb(m)

    if inspect.isclass(target):
        t = target(config)
        start = 0
        if checkpoint_path and os.path.exists(checkpoint_path):
            with open(checkpoint_path, "rb") as f:
                start, state, prior = _pickle.load(f)
            t.load_state(state)
            # keep the pre-crash history: without it, a crash after the
            # LAST checkpoint would resume into zero remaining
            # iterations and report an empty (silently discarded) trial
            metrics.extend(prior)
        for i in range(start, max_iterations):
            if should_stop is not None and should_stop():
                break
            try:
                m = dict(t.step())
            except StopIteration:
                break
            record(m, i)
            if (checkpoint_path and checkpoint_freq
                    and (i + 1) % checkpoint_freq == 0):
                tmp = checkpoint_path + ".tmp"
                with open(tmp, "wb") as f:
                    _pickle.dump((i + 1, t.save_state(), list(metrics)), f)
                os.replace(tmp, checkpoint_path)   # atomic: never torn
    else:
        gen = target(config)
        if not inspect.isgenerator(gen):
            raise TypeError("function trainables must be generators")
        for i, m in enumerate(gen):
            record(dict(m), i)
            if i + 1 >= max_iterations:
                break
            if should_stop is not None and should_stop():
                break
    return {"metrics": metrics}


@dataclass
class TrialJob:
    trial_id: str
    config: Dict[str, Any]
    status: str = WAITING
    metrics: List[Dict[str, Any]] = field(default_factory=list)
    error: str = ""


class TrainingService(ABC):
    """The NNI TrainingService seam (submitTrialJob / queryTrialJobs /
    cancelTrialJob / cleanUp)."""

    @abstractmethod
    def submit(self, trainable_ref: str, config: Dict[str, Any],
               trial_id: str, max_iterations: int) -> None: ...

    @abstractmethod
    def poll(self) -> List[TrialJob]: ...

    @abstractmethod
    def cancel(self, trial_id: str) -> None: ...

    @abstractmethod
    def shutdown(self) -> None: ...


class LocalService(TrainingService):
    """Trials on daemon threads in this process. A RUNNING trial is
    cancelable cooperatively: ``cancel`` raises a stop flag checked
    between iterations (threads cannot be killed; the iteration
    boundary is exactly where ASHA/median-stop act anyway)."""

    def __init__(self, max_concurrent: int = 4):
        self._sem = threading.Semaphore(max_concurrent)
        self._jobs: Dict[str, TrialJob] = {}
        self._stops: Dict[str, threading.Event] = {}
        self._lock = threading.Lock()

    def submit(self, trainable_ref, config, trial_id, max_iterations):
        job = TrialJob(trial_id, dict(config))
        stop = threading.Event()
        with self._lock:
            self._jobs[trial_id] = job
            self._stops[trial_id] = stop

        def on_metric(m):
            with self._lock:
                job.metrics.append(m)

        def work():
            with self._sem:
                with self._lock:
                    if job.status == CANCELED:
                        return
                    job.status = RUNNING
                try:
                    run_trial(trainable_ref, config, max_iterations,
                              metrics_cb=on_metric,
                              should_stop=stop.is_set)
                    with self._lock:
                        job.status = (CANCELED if stop.is_set()
                                      else SUCCEEDED)
                except BaseException as e:
                    with self._lock:
                        job.error = repr(e)
                        job.status = FAILED

        threading.Thread(target=work, daemon=True,
                         name=f"trial-{trial_id}").start()

    def poll(self):
        with self._lock:
            return list(self._jobs.values())

    def cancel(self, trial_id):
        with self._lock:
            job = self._jobs.get(trial_id)
            if job is None:
                return
            if job.status == WAITING:
                job.status = CANCELED
            stop = self._stops.get(trial_id)
        if stop is not None:
            stop.set()          # a RUNNING trial stops at the next
                                # iteration boundary and keeps partials

    def shutdown(self):
        pass


class SubprocessService(TrainingService):
    """One OS process per trial; results come back through a JSON file
    (the local training service's process-isolation contract — a crash
    or OOM in a trial cannot touch the manager)."""

    def __init__(self, max_concurrent: int = 4,
                 workdir: Optional[str] = None,
                 checkpoint_freq: int = 5):
        self._max = max_concurrent
        self._ckpt_freq = checkpoint_freq
        self._own_dir = workdir is None
        self._dir = workdir or tempfile.mkdtemp(prefix="tosem_trials_")
        self._jobs: Dict[str, TrialJob] = {}
        self._procs: Dict[str, subprocess.Popen] = {}
        self._queue: List[tuple] = []
        self._prog_off: Dict[str, int] = {}
        self._prog_cache: Dict[str, List[Dict[str, Any]]] = {}
        self._lock = threading.Lock()

    def submit(self, trainable_ref, config, trial_id, max_iterations):
        with self._lock:
            self._jobs[trial_id] = TrialJob(trial_id, dict(config))
            self._queue.append((trainable_ref, config, trial_id,
                                max_iterations))
        self._pump()

    def _out_path(self, trial_id: str) -> str:
        return os.path.join(self._dir, f"{trial_id}.json")

    def _pump(self) -> None:
        with self._lock:
            running = sum(1 for p in self._procs.values()
                          if p.poll() is None)
            while self._queue and running < self._max:
                ref, config, tid, iters = self._queue.pop(0)
                job = self._jobs[tid]
                if job.status == CANCELED:
                    continue
                env = dict(os.environ)
                # stderr to a FILE, never a pipe: a chatty trial filling
                # an undrained pipe buffer would block and hang forever
                from tosem_tpu_torch.tune.trial_worker import worker_argv
                errf = open(os.path.join(self._dir, f"{tid}.err"), "wb")
                proc = subprocess.Popen(
                    worker_argv(ref, json.dumps(config), iters,
                                self._out_path(tid),
                                os.path.join(self._dir,
                                             f"{tid}.progress"),
                                checkpoint_path=os.path.join(
                                    self._dir, f"{tid}.ckpt"),
                                checkpoint_freq=self._ckpt_freq),
                    env=env, stdout=subprocess.DEVNULL, stderr=errf)
                errf.close()
                self._procs[tid] = proc
                job.status = RUNNING
                running += 1

    def _progress(self, tid: str) -> List[Dict[str, Any]]:
        # incremental: keep a byte offset per trial so a poll loop over
        # a long trial's stream stays O(new lines)
        from tosem_tpu_torch.tune.trial_worker import read_progress_incr
        new, off = read_progress_incr(
            os.path.join(self._dir, f"{tid}.progress"),
            self._prog_off.get(tid, 0))
        self._prog_off[tid] = off
        self._prog_cache.setdefault(tid, []).extend(new)
        return self._prog_cache[tid]

    def poll(self):
        with self._lock:
            items = list(self._procs.items())
        for tid, proc in items:
            rc = proc.poll()
            if rc is None:
                # stream intermediate reports so schedulers can act on
                # a trial that is still RUNNING
                self._jobs[tid].metrics = self._progress(tid)
                continue
            job = self._jobs[tid]
            if job.status not in (SUCCEEDED, FAILED, CANCELED):
                out = self._out_path(tid)
                if rc == 0 and os.path.exists(out):
                    with open(out) as f:
                        job.metrics = json.load(f)["metrics"]
                    job.status = SUCCEEDED
                else:
                    err = b""
                    errp = os.path.join(self._dir, f"{tid}.err")
                    if os.path.exists(errp):
                        with open(errp, "rb") as f:
                            err = f.read()
                    job.error = f"rc={rc}: {err[-500:].decode(errors='replace')}"
                    job.status = FAILED
        self._pump()
        with self._lock:
            return list(self._jobs.values())

    def cancel(self, trial_id):
        with self._lock:
            job = self._jobs.get(trial_id)
            if job is None:
                return
            if job.status == WAITING:
                job.status = CANCELED
            proc = self._procs.get(trial_id)
        if proc is not None and proc.poll() is None:
            proc.kill()
            job.metrics = self._progress(trial_id)   # keep partials
            job.status = CANCELED

    def shutdown(self):
        with self._lock:
            procs = list(self._procs.values())
        for p in procs:
            if p.poll() is None:
                p.kill()
        if self._own_dir:        # a dir we made, we clean (no temp litter)
            import shutil
            shutil.rmtree(self._dir, ignore_errors=True)


class NodeAgentService(TrainingService):
    """Trials on remote node agents (cluster/node.py) — the remote
    training service. Each trial runs as a dedicated killable
    subprocess on its agent (the agent's trial plane): ``submit`` is a
    non-blocking ``start_trial`` RPC, ``poll`` pulls status + the
    intermediate-metric stream, and ``cancel`` kills a RUNNING trial
    mid-flight (``cancelTrialJob``,
    ``remoteMachineTrainingService.ts``). Placement: round-robin across
    agents; the agent's own admission gate queues beyond its pool.
    Gang-safe: pass ``reservation`` (a
    :class:`~tosem_tpu_torch.cluster.gang.GangReservation`) to run inside a
    placement-group bundle."""

    def __init__(self, nodes, max_concurrent: int = 4, reservation=None,
                 checkpoint_freq: int = 5):
        self._ckpt_freq = checkpoint_freq
        # keep a LIST by reference: an ElasticAgentPool hands over its
        # live ``nodes`` list so scaled-up agents join the round-robin
        # and torn-down agents leave it; other iterables are snapshotted
        self._nodes = nodes if isinstance(nodes, list) else list(nodes)
        if not self._nodes:
            raise ValueError("need at least one node agent")
        self._max = max_concurrent
        self._jobs: Dict[str, TrialJob] = {}
        self._node_of: Dict[str, Any] = {}
        self._poll_errs: Dict[str, int] = {}
        self._pending: List[tuple] = []
        self._lock = threading.Lock()
        self._rr = 0
        self._resv = reservation

    def submit(self, trainable_ref, config, trial_id, max_iterations):
        with self._lock:
            self._jobs[trial_id] = TrialJob(trial_id, dict(config))
            self._pending.append((trainable_ref, config, trial_id,
                                  max_iterations))
        self._pump()

    def _pump(self):
        """Dispatch queued trials up to the manager-side cap (the
        remote load bound the constructor advertises; the per-agent
        admission gate bounds each node separately)."""
        while True:
            with self._lock:
                live = sum(1 for tid, j in self._jobs.items()
                           if j.status == RUNNING
                           or (j.status == WAITING
                               and tid in self._node_of))
                if not self._pending or live >= self._max:
                    return
                ref, config, tid, iters = self._pending.pop(0)
                job = self._jobs[tid]
                if job.status == CANCELED:
                    continue
                if not self._nodes:      # elastic pool scaled to zero
                    self._pending.insert(0, (ref, config, tid, iters))
                    return
                node = self._nodes[self._rr % len(self._nodes)]
                self._rr += 1
                self._node_of[tid] = node
            pg = None
            if self._resv is not None \
                    and node.address in self._resv.counts:
                pg = self._resv.pg_id
            try:
                node.start_trial(tid, ref, config, iters, pg=pg,
                                 checkpoint_freq=self._ckpt_freq)
            except Exception as e:
                with self._lock:
                    job.error = repr(e)
                    job.status = FAILED

    def poll(self):
        self._pump()
        with self._lock:
            items = [(tid, job, self._node_of.get(tid))
                     for tid, job in self._jobs.items()]
        for tid, job, node in items:
            if node is None or job.status in (SUCCEEDED, FAILED,
                                              CANCELED):
                continue
            try:
                st = node.trial_status(tid, since=len(job.metrics))
            except Exception as e:
                # one transient RPC hiccup (timeout on a loaded agent)
                # must not permanently fail a healthy trial; after
                # repeated failures, give up AND kill the remote side so
                # it does not run on holding an agent slot
                n = self._poll_errs.get(tid, 0) + 1
                self._poll_errs[tid] = n
                if n >= 3:
                    with self._lock:
                        job.error = repr(e)
                        job.status = FAILED
                    try:
                        node.kill_trial(tid)
                    except Exception:
                        pass
                continue
            self._poll_errs.pop(tid, None)
            prefix = max(0, st["n_total"] - len(st["metrics"]))
            if prefix > len(job.metrics):
                # agent knows more history than our slice assumed
                # (should not happen; refetch whole rather than corrupt)
                st = node.trial_status(tid)
                prefix = 0
            with self._lock:
                # the agent sliced at our count: extend, don't replace
                job.metrics = job.metrics[:prefix] + st["metrics"]
                job.error = st["error"]
                job.status = st["status"]
        with self._lock:
            return list(self._jobs.values())

    def cancel(self, trial_id):
        with self._lock:
            job = self._jobs.get(trial_id)
            node = self._node_of.get(trial_id)
            if job is not None and node is None:
                job.status = CANCELED    # still queued manager-side
        if job is None or node is None:
            return
        try:
            node.kill_trial(trial_id)
        except Exception:
            pass

    def shutdown(self):
        with self._lock:
            items = list(self._jobs.items())
        for tid, job in items:
            if job.status in (WAITING, RUNNING):
                self.cancel(tid)


SERVICES = {
    "local": LocalService,
    "subprocess": SubprocessService,
}


def _last_metric(metrics, key):
    """Most recent report carrying ``key`` — the final entry may be a
    heterogeneous record (checkpoint stats etc.) without the configured
    metric, which must not discard the trial."""
    for m in reversed(metrics):
        if m.get(key) is not None:
            return m[key]
    return None


def run_with_service(trainable_ref: str, space: Dict[str, Any], *,
                     service: TrainingService, metric: str, mode: str,
                     num_samples: int, max_iterations: int = 100,
                     search_alg=None, scheduler=None, poll_s: float = 0.2,
                     timeout_s: float = 600.0,
                     max_in_flight: int = 4) -> Dict[str, Any]:
    """Provider-agnostic manager loop: suggest → submit → poll → observe
    (the nni_manager core loop). Final metric feeds the search algorithm;
    returns {trials, best_config, best_score}.

    ``scheduler`` (a :class:`~tosem_tpu_torch.tune.schedulers.TrialScheduler`)
    consumes the intermediate-metric stream every poll round and a STOP
    verdict cancels the trial MID-FLIGHT through the service
    (``cancelTrialJob`` on a running job) — ASHA/median-stop work
    against remote agents, not just the in-process path."""
    from tosem_tpu_torch.tune.schedulers import CONTINUE as CONTINUE_TRIAL
    from tosem_tpu_torch.tune.schedulers import STOP as STOP_TRIAL
    from tosem_tpu_torch.tune.search import RandomSearch

    if mode not in ("min", "max"):
        raise ValueError("mode must be min|max")
    alg = search_alg or RandomSearch()
    alg.set_space(space, mode)
    if scheduler is not None:
        scheduler.set_mode(metric, mode)
    sign = -1.0 if mode == "min" else 1.0
    configs: Dict[str, Dict[str, Any]] = {}
    submitted = 0
    observed: set = set()
    fed: Dict[str, int] = {}          # intermediate reports already fed
    stopped: set = set()              # trials the scheduler canceled
    deadline = time.monotonic() + timeout_s
    while True:
        jobs = {j.trial_id: j for j in service.poll()}
        if scheduler is not None:
            for tid, job in jobs.items():
                new = job.metrics[fed.get(tid, 0):]
                fed[tid] = fed.get(tid, 0) + len(new)
                verdict = CONTINUE_TRIAL
                for m in new:
                    if m.get(metric) is None:
                        continue
                    verdict = scheduler.on_result(
                        tid, int(m.get("training_iteration", fed[tid])),
                        m)
                    if verdict == STOP_TRIAL:
                        break
                if (verdict == STOP_TRIAL and tid not in stopped
                        and job.status in (WAITING, RUNNING)):
                    service.cancel(tid)
                    stopped.add(tid)
                if job.status not in (WAITING, RUNNING) \
                        and tid not in stopped:
                    scheduler.on_complete(tid)
                    stopped.add(tid)  # terminal: no more feeding needed
        # stagger submissions so adaptive searchers (TPE/BOHB/evolution)
        # see earlier results before proposing later configs — submitting
        # everything up-front would silently degrade them to random
        in_flight = sum(1 for j in jobs.values()
                        if j.status in (WAITING, RUNNING))
        while submitted < num_samples and in_flight < max_in_flight:
            cfg = alg.suggest()
            tid = f"t{submitted:04d}"
            configs[tid] = cfg
            service.submit(trainable_ref, cfg, tid, max_iterations)
            submitted += 1
            in_flight += 1
        done = submitted >= num_samples
        for tid in configs:
            job = jobs.get(tid)
            if job is None or job.status in (WAITING, RUNNING):
                done = False
                continue
            if tid not in observed and job.metrics \
                    and job.status in (SUCCEEDED, CANCELED):
                # an early-stopped (CANCELED) trial's partial result
                # still informs the searcher — Tune/ASHA semantics
                val = _last_metric(job.metrics, metric)
                if val is not None:
                    alg.observe(configs[tid], float(val))
                observed.add(tid)
        if done:
            break
        if time.monotonic() > deadline:
            raise TimeoutError("training service did not finish in time")
        time.sleep(poll_s)

    jobs = {j.trial_id: j for j in service.poll()}
    best_tid, best = None, float("-inf")
    rows = []
    for tid, cfg in configs.items():
        job = jobs[tid]
        score = (_last_metric(job.metrics, metric)
                 if job.status in (SUCCEEDED, CANCELED) and job.metrics
                 else None)
        score = None if score is None else float(score)
        status, error = job.status, job.error
        if status == SUCCEEDED and score is None:
            # completed without ever reporting the configured metric —
            # that's the trial's bug, not the experiment's; fail it alone
            status, error = FAILED, (
                f"trial finished without reporting metric {metric!r}")
        rows.append({"trial_id": tid, "config": cfg,
                     "status": status, "score": score,
                     "iterations": len(job.metrics), "error": error})
        if score is not None and sign * score > best:
            best, best_tid = sign * score, tid
    return {
        "trials": rows,
        "best_config": configs.get(best_tid),
        "best_score": None if best_tid is None else sign * best,
    }
