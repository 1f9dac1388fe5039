"""Head-node supervision: heartbeat failure detection, journaled state,
and automatic resubmission of work stranded on dead nodes.

The reference's GCS owns exactly this triple: node liveness via
heartbeats (``gcs_node_manager.cc`` / ``gcs_heartbeat_manager.cc``),
control-plane state persisted to Redis so the GCS can crash-restart
(``gcs_table_storage.cc``), and lease/actor reconstruction onto
surviving raylets. Here the head is the driver process:

- :class:`FailureDetector` probes each registered
  :class:`~tosem_tpu_torch.cluster.node.RemoteNode` on a cadence and declares
  it dead after ``miss_threshold`` consecutive failed probes.
- :class:`HeadJournal` is an append-only JSONL journal of control
  events (nodes added/removed, work submitted/finished) with a
  ``reconcile`` replay, so a crashed head restarts, replays the
  journal, re-probes the nodes it knew, and learns which work items
  never finished.
- :class:`NodePool` ties both together: ``submit``/``map`` route tasks
  to live nodes and transparently retry on surviving nodes when a node
  dies mid-call; trials started through the pool are resubmitted under
  the SAME trial id to a surviving node, so a shared ``checkpoint_dir``
  resumes them from their last checkpoint instead of restarting; and
  layers composed onto the pool (cluster serving) hear of every death
  and suspicion through listeners.

A copy of the JAX package's ``cluster/supervisor.py``. The journal's
events and ``reconcile`` are the reference's, trial events included, so
a journal written by either package reconciles in the other.

Chaos seam: ``cluster.submit`` fires per routed task (action
``kill_node`` hard-kills the chosen node first, simulating node loss at
the worst moment); deterministic by event ordinal like every other
site.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from tosem_tpu_torch.chaos import hooks as _chaos
from tosem_tpu_torch.chaos import network as _net
from tosem_tpu_torch.cluster.fencing import EpochFence, StaleEpochError
from tosem_tpu_torch.cluster.node import NodeDrainingError, RemoteNode

__all__ = ["NodeLostError", "StaleEpochError", "HeadJournal",
           "FailureDetector", "NodePool"]


class NodeLostError(RuntimeError):
    """Every candidate node failed (or none are alive) for this call."""


# --------------------------------------------------------------- journal


class HeadJournal:
    """Append-only JSONL journal of head-node control state.

    Each :meth:`record` is one fsync'd line, so the journal survives a
    head crash mid-write (a torn final line is skipped on load — same
    contract as the trial progress files).

    Epoch lease: opening a journal ACQUIRES the next epoch from the
    fence file beside it (``<path>.epoch``), and every :meth:`record`
    both re-checks the fence and stamps the event with the holder's
    epoch. A head that was partitioned away while a replacement
    recovered (which re-opened the journal and therefore bumped the
    fence) gets :class:`StaleEpochError` on its next append — split-
    brain journal writes are REJECTED at the write, and ``reconcile``
    additionally drops any stale-epoch line that slipped in during the
    handoff window.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "ab")
        self.fence = EpochFence(path + ".epoch")
        self.epoch = self.fence.acquire()

    def record(self, event: str, **fields: Any) -> None:
        self.fence.check(self.epoch)
        fields.setdefault("epoch", self.epoch)
        line = json.dumps({"event": event, **fields},
                          sort_keys=True).encode() + b"\n"
        with self._lock:
            self._f.write(line)
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass

    @staticmethod
    def load(path: str) -> List[Dict[str, Any]]:
        events: List[Dict[str, Any]] = []
        try:
            with open(path, "rb") as f:
                for line in f.read().split(b"\n"):
                    if not line:
                        continue
                    try:
                        events.append(json.loads(line))
                    except json.JSONDecodeError:
                        break       # torn tail from a mid-write crash
        except OSError:
            pass
        return events

    @staticmethod
    def reconcile(events: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Replay the journal into the head's last known state:
        registered node addresses, work submitted-but-not-finished,
        trials started-but-not-finished (with their last known node),
        plus the serving control plane — deployments declared and the
        replica placements live at crash time, so a recovered head can
        rebuild the routing table (``ClusterServe.recover``).

        Epoch discipline: the replay tracks the highest epoch any event
        has carried so far and DROPS events stamped with an older one —
        a stale head that raced a line into the journal during the
        recovery handoff cannot resurrect a placement or membership the
        new head already superseded. Events without an epoch field
        (pre-lease journals) always apply."""
        nodes: Dict[str, str] = {}           # name -> address
        work: Dict[str, Dict[str, Any]] = {}
        trials: Dict[str, Dict[str, Any]] = {}
        deployments: Dict[str, Dict[str, Any]] = {}
        placements: Dict[str, Dict[str, Any]] = {}  # replica_id -> event
        train_jobs: Dict[str, Dict[str, Any]] = {}  # job -> progress
        epoch = 0
        stale_dropped = 0
        for e in events:
            ev = e.get("event")
            e_epoch = e.get("epoch")
            if e_epoch is not None:
                if int(e_epoch) < epoch:
                    stale_dropped += 1
                    continue                # stale-head write: fenced out
                epoch = int(e_epoch)
            if ev == "node_added":
                nodes[e["name"]] = e["address"]
            elif ev == "node_removed":
                nodes.pop(e["name"], None)
            elif ev == "work_submitted":
                work[e["work_id"]] = e
            elif ev in ("work_done", "work_failed"):
                work.pop(e["work_id"], None)
            elif ev == "trial_started":
                trials[e["trial_id"]] = e
            elif ev in ("trial_done", "trial_failed", "trial_canceled"):
                trials.pop(e["trial_id"], None)
            elif ev == "deployment_created":
                deployments[e["deployment"]] = e
            elif ev == "deployment_deleted":
                deployments.pop(e["deployment"], None)
                placements = {rid: p for rid, p in placements.items()
                              if p["deployment"] != e["deployment"]}
            elif ev == "replica_placed":
                placements[e["replica_id"]] = e
            elif ev == "replica_removed":
                placements.pop(e["replica_id"], None)
            elif ev == "train_started":
                train_jobs[e["job"]] = {"step": 0,
                                        "world": e.get("world"),
                                        "grain": e.get("grain"),
                                        "finished": False}
            elif ev == "train_step_done":
                tj = train_jobs.setdefault(e["job"], {})
                tj["step"] = int(e["step"])
                # fit() is resumable: a step AFTER a train_finished
                # means the job is live again (finished replays only
                # if it is the job's last word)
                tj["finished"] = False
            elif ev in ("train_shrunk", "train_grown"):
                tj = train_jobs.setdefault(e["job"], {"finished": False})
                tj["world"] = e.get("world")
                tj["step"] = max(int(e.get("step", 0)),
                                 int(tj.get("step", 0)))
            elif ev == "train_finished":
                train_jobs.setdefault(e["job"], {})["finished"] = True
        return {"nodes": nodes, "outstanding_work": work,
                "outstanding_trials": trials,
                "deployments": deployments, "placements": placements,
                "train_jobs": train_jobs, "epoch": epoch,
                "stale_dropped": stale_dropped}


# ------------------------------------------------------ failure detector


class FailureDetector:
    """Adaptive (phi-accrual-style) liveness detection.

    The fixed miss counter survives as the FLOOR — ``miss_threshold``
    consecutive failed probes still declare death exactly once
    (``on_dead``), keeping the crash-stop behaviour deterministic for
    tests. On top of it:

    - **Suspicion before death.** The first missed probe moves a node
      to ``SUSPECT`` (``on_suspect(name, node, True)``) so the serving
      layer can de-preference its replicas and prep a drain BEFORE the
      node is declared dead; a successful probe clears suspicion
      (``on_suspect(name, node, False)``). Query with :meth:`state` /
      :meth:`suspects`.
    - **Phi-accrual acceleration.** Each node's successful-probe
      inter-arrival history (Hayashibara et al.) yields
      ``phi = elapsed / (mean · ln 10)`` — the exponential-tail
      suspicion level. A missed probe whose phi already exceeds
      ``dead_phi`` skips the remaining miss budget: a node that has
      been silent for many learned intervals is declared dead on
      evidence, not on a fixed count.
    - **Concurrent probing** (one thread per target, joined against a
      shared deadline): one wedged node costs ONE probe timeout for
      the whole sweep, not one per node behind it in iteration order.
      A probe that has not returned by the deadline counts as a miss
      for this sweep.

    Emulated-network faults (:mod:`tosem_tpu_torch.chaos.network`) apply at
    the probe: a head↔node partition fails the probe outright, a
    slow-node fault stalls it by the injected delay — so partition and
    gray-slow chaos plans exercise exactly this code path.
    """

    def __init__(self, interval_s: float = 0.5, miss_threshold: int = 3,
                 probe_timeout: float = 2.0,
                 on_dead: Optional[Callable[[str, RemoteNode], None]] = None,
                 on_suspect: Optional[
                     Callable[[str, RemoteNode, bool], None]] = None,
                 dead_phi: float = 3.0, history: int = 32):
        self.interval_s = interval_s
        self.miss_threshold = max(1, miss_threshold)
        self.probe_timeout = probe_timeout
        self.on_dead = on_dead
        self.on_suspect = on_suspect
        self.dead_phi = dead_phi
        self._lock = threading.Lock()
        self._nodes: Dict[str, RemoteNode] = {}
        self._misses: Dict[str, int] = {}
        self._dead: Dict[str, RemoteNode] = {}
        self._suspect: Dict[str, bool] = {}
        self._last_ok: Dict[str, float] = {}
        self._intervals: Dict[str, deque] = {}
        self._history = max(2, history)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add(self, name: str, node: RemoteNode) -> None:
        with self._lock:
            self._nodes[name] = node
            self._misses[name] = 0
            self._dead.pop(name, None)
            self._suspect.pop(name, None)
            self._last_ok.pop(name, None)
            self._intervals[name] = deque(maxlen=self._history)

    def remove(self, name: str) -> None:
        with self._lock:
            self._nodes.pop(name, None)
            self._misses.pop(name, None)
            self._dead.pop(name, None)
            self._suspect.pop(name, None)
            self._last_ok.pop(name, None)
            self._intervals.pop(name, None)

    def live_names(self) -> List[str]:
        with self._lock:
            return list(self._nodes)

    def is_dead(self, name: str) -> bool:
        with self._lock:
            return name in self._dead

    def is_suspect(self, name: str) -> bool:
        with self._lock:
            return bool(self._suspect.get(name))

    def suspects(self) -> List[str]:
        with self._lock:
            return [n for n, s in self._suspect.items() if s]

    def state(self, name: str) -> str:
        """``"alive"`` | ``"suspect"`` | ``"dead"`` | ``"unknown"``."""
        with self._lock:
            if name in self._dead:
                return "dead"
            if self._suspect.get(name):
                return "suspect"
            if name in self._nodes:
                return "alive"
            return "unknown"

    def phi(self, name: str, now: Optional[float] = None) -> float:
        """Suspicion level: how many decades of improbability the
        current silence represents under an exponential model of the
        node's learned probe inter-arrival times. 0.0 with no history;
        ~0.43 after one mean interval; past :attr:`dead_phi` the node
        has been silent for ``dead_phi·ln10`` mean intervals."""
        now = time.monotonic() if now is None else now
        with self._lock:
            last = self._last_ok.get(name)
            hist = self._intervals.get(name)
            if last is None or not hist:
                return 0.0
            mean = sum(hist) / len(hist)
        if mean <= 0.0:
            return 0.0
        return max(0.0, (now - last) / (mean * math.log(10.0)))

    def declare_dead(self, name: str) -> None:
        """Out-of-band death report (e.g. a submit hit a closed socket):
        skip the remaining probe budget — the caller KNOWS."""
        with self._lock:
            node = self._nodes.pop(name, None)
            self._misses.pop(name, None)
            self._suspect.pop(name, None)
            if node is None:
                return
            self._dead[name] = node
        if self.on_dead is not None:
            self.on_dead(name, node)

    def _probe_one(self, name: str, node: RemoteNode,
                   results: Dict[str, bool]) -> None:
        net = _net.state()
        delay = net.delay(name)
        if delay > 0:
            time.sleep(delay)
        if net.dropped(_net.HEAD, name):
            results[name] = False
            return
        try:
            results[name] = node.alive(timeout=self.probe_timeout)
        except Exception:
            results[name] = False

    def check_once(self) -> List[str]:
        """One probe sweep; returns names declared dead BY this sweep."""
        with self._lock:
            targets = list(self._nodes.items())
        # chaos seam: one ``cluster.probe`` event per node per sweep
        # (fired in registration order BEFORE the probes launch, so
        # ordinals stay deterministic even though probing is
        # concurrent). partition/heal/slow_node mutate the emulated
        # network that the probes below consult.
        for name, _node in targets:
            act = _chaos.fire("cluster.probe", target=name)
            if act is None:
                continue
            net = _net.state()
            if act["action"] == "partition":
                net.partition([_net.HEAD], [name])
            elif act["action"] == "heal":
                net.heal()
            elif act["action"] == "slow_node":
                net.slow_node(name, act.get("delay_s") or 0.0)
        results: Dict[str, bool] = {}
        if len(targets) == 1:
            # single node: no thread tax, identical semantics
            self._probe_one(targets[0][0], targets[0][1], results)
        elif targets:
            threads = []
            for name, node in targets:
                t = threading.Thread(target=self._probe_one,
                                     args=(name, node, results),
                                     daemon=True,
                                     name=f"tosem-probe-{name}")
                t.start()
                threads.append(t)
            # shared deadline: the sweep costs ONE probe budget total,
            # however many nodes hang; stragglers count as misses
            deadline = time.monotonic() + self.probe_timeout + 0.5
            for t in threads:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
        died: List[str] = []
        now = time.monotonic()
        suspect_events: List[tuple] = []
        for name, node in targets:
            ok = results.get(name, False)   # unreturned probe = miss
            declare = False
            with self._lock:
                if name not in self._nodes:
                    continue        # removed/declared dead concurrently
                if ok:
                    last = self._last_ok.get(name)
                    if last is not None:
                        self._intervals[name].append(now - last)
                    self._last_ok[name] = now
                    self._misses[name] = 0
                    if self._suspect.pop(name, None):
                        suspect_events.append((name, node, False))
                    continue
                self._misses[name] = self._misses.get(name, 0) + 1
                if not self._suspect.get(name):
                    self._suspect[name] = True
                    suspect_events.append((name, node, True))
                if self._misses[name] >= self.miss_threshold:
                    declare = True
            if not declare and self._misses.get(name, 0) >= 2 \
                    and self.phi(name, now) >= self.dead_phi:
                declare = True      # phi-accrual acceleration
            if declare:
                self.declare_dead(name)
                died.append(name)
        if self.on_suspect is not None:
            for name, node, entering in suspect_events:
                if name in died:
                    continue        # went straight to dead this sweep
                try:
                    self.on_suspect(name, node, entering)
                except Exception:
                    pass            # suspicion callbacks are advisory
        return died

    def start(self) -> "FailureDetector":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="tosem-failure-detector")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check_once()
            except Exception:
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


# --------------------------------------------------------------- pool


class NodePool:
    """Head-side router over node agents with self-healing semantics.

    ``submit``/``map`` retry on surviving nodes when a node dies
    mid-call; trials are tracked and resubmitted (same id) to a
    survivor when their node is declared dead — give trials a shared
    ``checkpoint_dir`` so the resubmission RESUMES from the last
    checkpoint. All control transitions are journaled when a
    ``journal_path`` is given, so :meth:`recover` can rebuild a crashed
    head's state.
    """

    def __init__(self, journal_path: Optional[str] = None,
                 heartbeat_interval_s: float = 0.5,
                 miss_threshold: int = 2,
                 probe_timeout: float = 2.0,
                 start_detector: bool = False):
        self._lock = threading.RLock()
        self._nodes: Dict[str, RemoteNode] = {}
        self._rr = 0
        self._journal = HeadJournal(journal_path) if journal_path else None
        self._trials: Dict[str, Dict[str, Any]] = {}
        # node-death listeners beyond the trial plane (the cluster
        # serving controller re-places a dead node's replicas through
        # one of these) — called AFTER the pool's own resubmission
        self._death_listeners: List[Callable[[str, RemoteNode], None]] = []
        # suspicion listeners: fired on SUSPECT enter/clear so the
        # serving layer can de-preference a gray node's replicas
        self._suspect_listeners: List[
            Callable[[str, RemoteNode, bool], None]] = []
        self.detector = FailureDetector(
            interval_s=heartbeat_interval_s, miss_threshold=miss_threshold,
            probe_timeout=probe_timeout, on_dead=self._on_node_dead,
            on_suspect=self._on_node_suspect)
        if start_detector:
            self.detector.start()

    @property
    def epoch(self) -> int:
        """This head's epoch lease (0 when running journal-less —
        unfenced receivers accept epoch-less writes)."""
        return self._journal.epoch if self._journal is not None else 0

    # -- membership ----------------------------------------------------

    def add_node(self, node: RemoteNode, name: Optional[str] = None) -> str:
        name = name or node.address
        with self._lock:
            self._nodes[name] = node
        self.detector.add(name, node)
        self._record("node_added", name=name, address=node.address)
        return name

    def remove_node(self, name: str) -> None:
        with self._lock:
            node = self._nodes.pop(name, None)
        self.detector.remove(name)
        if node is not None:
            self._record("node_removed", name=name)

    def live_nodes(self) -> Dict[str, RemoteNode]:
        with self._lock:
            return {n: v for n, v in self._nodes.items()
                    if not self.detector.is_dead(n)}

    def _record(self, event: str, **fields: Any) -> None:
        if self._journal is not None:
            self._journal.record(event, **fields)

    def record_event(self, event: str, **fields: Any) -> None:
        """Journal a control event on behalf of a layer composed onto
        this pool (the serving controller's placements ride the SAME
        journal, so one ``recover`` rebuilds both planes)."""
        self._record(event, **fields)

    def add_death_listener(
            self, fn: Callable[[str, RemoteNode], None]) -> None:
        """Run ``fn(name, node)`` whenever a node is declared dead,
        after the pool's own trial resubmission. Listener errors are
        journaled, never propagated — one broken listener must not
        stop the detector sweep or other listeners."""
        with self._lock:
            self._death_listeners.append(fn)

    def add_suspect_listener(
            self, fn: Callable[[str, RemoteNode, bool], None]) -> None:
        """Run ``fn(name, node, entering)`` when a node enters
        (``True``) or clears (``False``) the detector's SUSPECT state —
        the pre-death hook for router de-preferencing and drain prep."""
        with self._lock:
            self._suspect_listeners.append(fn)

    def _on_node_suspect(self, name: str, node: RemoteNode,
                         entering: bool) -> None:
        with self._lock:
            listeners = list(self._suspect_listeners)
        for fn in listeners:
            try:
                fn(name, node, entering)
            except Exception as e:
                self._record("suspect_listener_error", name=name,
                             error=repr(e))

    def _on_node_dead(self, name: str, node: RemoteNode) -> None:
        """Detector callback: drop the corpse and resubmit its trials
        to survivors (same trial id ⇒ checkpoint resume), then tell the
        listeners."""
        with self._lock:
            self._nodes.pop(name, None)
            stranded = [tid for tid, t in self._trials.items()
                        if t["node"] == name and not t.get("terminal")]
            listeners = list(self._death_listeners)
        self._record("node_removed", name=name, reason="heartbeat")
        for tid in stranded:
            try:
                self._resubmit_trial(tid)
            except Exception as e:
                self._record("trial_failed", trial_id=tid, error=repr(e))
                with self._lock:
                    self._trials[tid]["terminal"] = True
                    self._trials[tid]["error"] = repr(e)
        for fn in listeners:
            try:
                fn(name, node)
            except Exception as e:
                self._record("death_listener_error", name=name,
                             error=repr(e))

    # -- task plane ----------------------------------------------------

    def _pick_locked(self, exclude: set) -> Optional[str]:
        names = [n for n in self._nodes
                 if n not in exclude and not self.detector.is_dead(n)]
        if not names:
            return None
        self._rr += 1
        return names[self._rr % len(names)]

    def submit(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        """Run ``fn`` on some live node; on node loss mid-call the task
        is resubmitted to a survivor (at-least-once — like the
        runtime's task retries, side effects may run twice)."""
        work_id = uuid.uuid4().hex[:12]
        self._record("work_submitted", work_id=work_id,
                     fn=getattr(fn, "__name__", str(fn)))
        tried: set = set()
        last_err: Optional[BaseException] = None
        while True:
            with self._lock:
                name = self._pick_locked(tried)
                node = self._nodes.get(name) if name else None
            if node is None:
                self._record("work_failed", work_id=work_id,
                             error=repr(last_err))
                raise NodeLostError(
                    f"no live node could run work {work_id}"
                    + (f" (last error: {last_err!r})" if last_err else ""))
            act = _chaos.fire("cluster.submit", target=name)
            if act is not None and act["action"] == "kill_node":
                # chaos: the node dies the instant work is routed to it
                node.kill()
            try:
                out = node.submit(fn, *args, **kwargs)
            except NodeDrainingError as e:
                # draining is deliberate, not death: route around it
                tried.add(name)
                last_err = e
                continue
            except (ConnectionError, TimeoutError, OSError) as e:
                tried.add(name)
                last_err = e
                self.detector.declare_dead(name)
                continue
            self._record("work_done", work_id=work_id)
            return out

    def map(self, fn: Callable, items) -> List[Any]:
        return [self.submit(fn, it) for it in items]

    # -- trial plane ---------------------------------------------------

    def start_trial(self, trial_id: str, trainable_ref: str,
                    config: Dict[str, Any], max_iterations: int,
                    checkpoint_dir: Optional[str] = None,
                    checkpoint_freq: int = 5) -> str:
        """Route a trial to a live node and track it for resubmission.
        With a shared ``checkpoint_dir``, a node death mid-trial resumes
        the trial on a survivor from its last checkpoint (same-id
        resubmit); without one, the resubmitted trial restarts."""
        with self._lock:
            self._trials[trial_id] = {
                "trainable_ref": trainable_ref, "config": dict(config),
                "max_iterations": max_iterations,
                "checkpoint_dir": checkpoint_dir,
                "checkpoint_freq": checkpoint_freq,
                "node": None, "resubmits": 0, "terminal": False,
            }
        return self._resubmit_trial(trial_id)

    def _resubmit_trial(self, trial_id: str) -> str:
        with self._lock:
            t = self._trials[trial_id]
            tried: set = {t["node"]} if t["node"] else set()
        last_err: Optional[BaseException] = None
        while True:
            with self._lock:
                name = self._pick_locked(tried)
                node = self._nodes.get(name) if name else None
            if node is None:
                raise NodeLostError(
                    f"no live node for trial {trial_id!r}"
                    + (f" (last error: {last_err!r})" if last_err else ""))
            try:
                node.start_trial(trial_id, t["trainable_ref"], t["config"],
                                 t["max_iterations"],
                                 checkpoint_freq=t["checkpoint_freq"],
                                 checkpoint_dir=t["checkpoint_dir"])
            except (ConnectionError, TimeoutError, OSError) as e:
                tried.add(name)
                last_err = e
                self.detector.declare_dead(name)
                continue
            with self._lock:
                t["node"] = name
                t["resubmits"] += 1
            self._record("trial_started", trial_id=trial_id, node=name,
                         attempt=t["resubmits"])
            return name

    def trial_status(self, trial_id: str) -> Dict[str, Any]:
        with self._lock:
            t = self._trials[trial_id]
            # a trial whose resubmission already failed terminally (no
            # surviving nodes) must report that, not RESUBMITTING forever
            if t.get("terminal") and t.get("error"):
                return {"status": "FAILED", "metrics": [], "n_total": 0,
                        "error": t["error"]}
            name = t["node"]
            node = self._nodes.get(name)
        if node is None:
            return {"status": "RESUBMITTING", "metrics": [],
                    "n_total": 0, "error": ""}
        try:
            st = node.trial_status(trial_id)
        except (ConnectionError, TimeoutError, OSError):
            # declare the node we actually probed — by now the detector
            # may have re-homed the trial onto a healthy replacement
            self.detector.declare_dead(name)
            return {"status": "RESUBMITTING", "metrics": [],
                    "n_total": 0, "error": ""}
        if st["status"] in ("SUCCEEDED", "FAILED", "CANCELED"):
            with self._lock:
                if not t.get("terminal"):
                    t["terminal"] = True
                    self._record(
                        "trial_done" if st["status"] == "SUCCEEDED"
                        else "trial_failed", trial_id=trial_id,
                        status=st["status"])
        return st

    def wait_trial(self, trial_id: str, timeout: float = 120.0,
                   poll_s: float = 0.2) -> Dict[str, Any]:
        """Poll until the trial reaches a terminal state, driving the
        failure detector between polls so node death is noticed even
        without the background thread running."""
        deadline = time.monotonic() + timeout
        st: Dict[str, Any] = {"status": "UNKNOWN"}
        while time.monotonic() < deadline:
            self.detector.check_once()
            st = self.trial_status(trial_id)
            if st["status"] in ("SUCCEEDED", "FAILED", "CANCELED"):
                return st
            time.sleep(poll_s)
        raise TimeoutError(f"trial {trial_id!r} not terminal after "
                           f"{timeout}s (last: {st['status']})")

    # -- head crash-restart --------------------------------------------

    @classmethod
    def recover(cls, journal_path: str,
                probe_timeout: float = 2.0, **kwargs: Any
                ) -> "NodePool":
        """Rebuild a head from its journal: re-register every node that
        still answers health probes, journal the ones that don't as
        removed, and leave ``outstanding_work``/``outstanding_trials``
        on the instance for the caller to resubmit."""
        state = HeadJournal.reconcile(HeadJournal.load(journal_path))
        pool = cls(journal_path=journal_path, probe_timeout=probe_timeout,
                   **kwargs)
        # opening the journal acquired the NEXT epoch from the fence —
        # the old holder's first append after this line raises
        # StaleEpochError; record the handoff for the audit trail
        pool._record("head_recovered", prev_epoch=state.get("epoch", 0))
        for name, address in state["nodes"].items():
            node = RemoteNode(address)
            if node.alive(timeout=probe_timeout):
                pool.add_node(node, name=name)
            else:
                node.close()
                pool._record("node_removed", name=name,
                             reason="dead at recovery")
        pool.outstanding_work = state["outstanding_work"]
        pool.outstanding_trials = state["outstanding_trials"]
        # serving control plane at crash time: deployments declared and
        # replicas placed — ClusterServe.recover consumes these to
        # rebuild the routing table (re-adopting replica processes that
        # outlived the head, re-placing the rest)
        pool.deployments = state["deployments"]
        pool.placements = state["placements"]
        # training progress at crash time: which jobs were live and the
        # last journaled step — what a recovered head resumes from
        pool.train_jobs = state["train_jobs"]
        return pool

    def close(self, close_nodes: bool = False) -> None:
        self.detector.stop()
        if close_nodes:
            with self._lock:
                nodes = list(self._nodes.values())
            for n in nodes:
                try:
                    n.close()
                except Exception:
                    pass
        if self._journal is not None:
            self._journal.close()
