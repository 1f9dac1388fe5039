"""Experiment manager — the NNI experiment API / ``nnictl`` role.

The reference manages HPO experiments as durable entities (`nni/
experiment/experiment.py` Experiment.start/resume/stop, `nnictl
create/status/list` backed by the experiment sqlite + manager service).
Here an experiment is a JSON spec persisted in the cluster
:class:`~tosem_tpu_torch.cluster.kv.KVStore`; running one materializes the
search space / scheduler / search algorithm from their registry names
and drives :func:`tosem_tpu_torch.tune.run`, writing status transitions and
the trial table back to the store — so ``status``/``results`` work from
any process over the shared db file. The port's copy of
``tosem_tpu/tune/experiment.py``, on the port's ``cluster/kv``.

Spec schema (JSON/YAML)::

    name: quad-demo
    trainable: tosem_tpu_torch.tune.examples:quadratic  # module:fn/class
    space:
      x:   {type: uniform, low: -5, high: 5}
      lr:  {type: loguniform, low: 1.e-3, high: 1.0}
      arm: {type: choice, values: [a, b]}
    metric: loss
    mode: min
    num_samples: 16
    max_iterations: 20
    scheduler: asha          # fifo|asha|median|pbt|hyperband|curvefit
    search: tpe              # random|grid|tpe|evolution|gp|bohb|pso
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

from tosem_tpu_torch.cluster.kv import KVStore
from tosem_tpu_torch.tune.schedulers import (ASHAScheduler,
                                             CurveFittingAssessor,
                                             FIFOScheduler, HyperBandScheduler,
                                             MedianStoppingRule, PBTScheduler)
from tosem_tpu_torch.tune.search import (BOHBSearch, Choice, EvolutionSearch,
                                         GPSearch, GridSearch, GridValues,
                                         LogUniform, PSOSearch, RandInt,
                                         RandomSearch, TPESearch, Uniform)

_NS_SPEC = "hpo/spec"
_NS_STATE = "hpo/state"
_NS_LOCK = "hpo/lock"

SCHEDULERS = {
    "fifo": FIFOScheduler,
    "asha": ASHAScheduler,
    "median": MedianStoppingRule,
    "pbt": PBTScheduler,
    "hyperband": HyperBandScheduler,
    "curvefit": CurveFittingAssessor,
}

SEARCHERS = {
    "random": RandomSearch,
    "grid": GridSearch,
    "tpe": TPESearch,
    "evolution": EvolutionSearch,
    "gp": GPSearch,
    "bohb": BOHBSearch,
    "pso": PSOSearch,
}


# ------------------------------------------------- space serialization

def space_from_json(spec: Dict[str, Any]) -> Dict[str, Any]:
    """JSON search-space description → Domain objects (the
    ``search_space.json`` convention of the reference)."""
    out: Dict[str, Any] = {}
    for key, d in spec.items():
        if not isinstance(d, dict) or "type" not in d:
            out[key] = d                       # constant
            continue
        t = d["type"]
        if t == "uniform":
            out[key] = Uniform(float(d["low"]), float(d["high"]))
        elif t == "loguniform":
            out[key] = LogUniform(float(d["low"]), float(d["high"]))
        elif t == "randint":
            out[key] = RandInt(int(d["low"]), int(d["high"]))
        elif t == "choice":
            out[key] = Choice(list(d["values"]))
        elif t == "grid":
            out[key] = GridValues(list(d["values"]))
        else:
            raise ValueError(f"unknown domain type {t!r} for {key!r}")
    return out


def space_to_json(space: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, dom in space.items():
        if isinstance(dom, Uniform):
            out[key] = {"type": "uniform", "low": dom.low, "high": dom.high}
        elif isinstance(dom, LogUniform):
            out[key] = {"type": "loguniform", "low": dom.low,
                        "high": dom.high}
        elif isinstance(dom, RandInt):
            out[key] = {"type": "randint", "low": dom.low, "high": dom.high}
        elif isinstance(dom, Choice):
            out[key] = {"type": "choice", "values": list(dom.values)}
        elif isinstance(dom, GridValues):
            out[key] = {"type": "grid", "values": list(dom.values)}
        else:
            out[key] = dom
    return out


# one 'module:attr' parsing contract for every trial-launching path
from tosem_tpu_torch.tune.providers import resolve_target as _resolve_target


class ExperimentManager:
    """CRUD + run over persisted experiment specs."""

    def __init__(self, kv: Optional[KVStore] = None,
                 path: Optional[str] = None):
        self.kv = kv or KVStore(path or ":memory:")

    # ----------------------------------------------------------- CRUD

    def create(self, spec: Dict[str, Any]) -> str:
        name = spec.get("name")
        if not name:
            raise ValueError("experiment spec needs a 'name'")
        for req in ("trainable", "space", "metric", "mode"):
            if req not in spec:
                raise ValueError(f"experiment spec needs {req!r}")
        space_from_json(spec["space"])          # validate early
        if spec.get("scheduler", "fifo") not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {spec['scheduler']!r}")
        if spec.get("search", "random") not in SEARCHERS:
            raise ValueError(f"unknown search {spec['search']!r}")
        if not self.kv.cas(_NS_SPEC, name, None,
                           json.dumps(spec, sort_keys=True).encode()):
            raise ValueError(f"experiment {name!r} already exists")
        self._set_state(name, {"status": "created",
                               "created_at": time.time()})
        return name

    def list(self) -> List[Dict[str, Any]]:
        out = []
        for n in self.kv.keys(_NS_SPEC):
            try:
                out.append(dict(self.status(n), name=n))
            except KeyError:
                pass            # deleted concurrently by another process
        return out

    def spec(self, name: str) -> Dict[str, Any]:
        blob = self.kv.get(_NS_SPEC, name)
        if blob is None:
            raise KeyError(f"no experiment {name!r}")
        return json.loads(blob)

    def status(self, name: str) -> Dict[str, Any]:
        self.spec(name)                         # existence check
        blob = self.kv.get(_NS_STATE, name)
        return json.loads(blob) if blob else {"status": "created"}

    def delete(self, name: str) -> bool:
        self.kv.delete(_NS_STATE, name)
        return self.kv.delete(_NS_SPEC, name)

    def results(self, name: str) -> List[Dict[str, Any]]:
        blob = self.kv.get(_NS_STATE, name)
        st = json.loads(blob) if blob else {}
        return st.get("trials", [])

    # ------------------------------------------------------------ run

    def _try_lock(self, name: str, force: bool) -> Optional[bytes]:
        """Acquire the run lock; returns this runner's payload (for the
        conditional release) or None. A lock whose holder process is
        verifiably dead (same host) or that the caller forces is taken
        over — a crashed runner must not wedge the experiment; an
        UNREADABLE lock is treated as held (the holder may be alive)."""
        import os
        payload = json.dumps({"pid": os.getpid(),
                              "t": time.time()}).encode()
        # small retry loop: the observed lock value can change between
        # the read and the CAS (holder releasing, another takeover) —
        # force in particular must not lose to that race
        for _ in range(4):
            if self.kv.cas(_NS_LOCK, name, None, payload):
                return payload
            blob = self.kv.get(_NS_LOCK, name)
            if blob is None:                   # released between calls
                continue
            stale = force
            if not stale:
                try:
                    holder = json.loads(blob)
                    os.kill(int(holder["pid"]), 0)  # raises if dead
                except ProcessLookupError:
                    stale = True                    # holder crashed
                except PermissionError:
                    return None                     # alive, other user
                except (ValueError, KeyError, TypeError):
                    return None   # unreadable: assume held, need force
            if not stale:
                return None                         # holder is alive
            if self.kv.cas(_NS_LOCK, name, blob, payload):
                return payload
        return None

    def run(self, name: str, verbose: bool = False,
            force: bool = False) -> Dict[str, Any]:
        """``force=True`` takes over a live lock (operator override);
        locks held by dead processes are reclaimed automatically."""
        from tosem_tpu_torch.tune.tune import run as tune_run
        spec = self.spec(name)
        # single-runner guard: CAS on a lock key, so a second concurrent
        # `run` of the same experiment fails fast instead of clobbering
        # the first one's results (the nnictl one-manager-per-experiment
        # invariant)
        my_lock = self._try_lock(name, force)
        if my_lock is None:
            raise RuntimeError(f"experiment {name!r} is already running")
        self._set_state(name, {"status": "running",
                               "started_at": time.time()})
        try:
            # pluggable training service (NNI trialDispatcher seam):
            # spec["training_service"] routes trials through
            # tosem_tpu_torch.tune.providers instead of the in-process actor
            # loop — same trainable, different placement; both paths
            # share the persist/unlock epilogue below
            if spec.get("training_service"):
                state = self._run_via_service(name, spec)
            else:
                trainable = _resolve_target(spec["trainable"])
                space = space_from_json(spec["space"])
                sched_kw = dict(spec.get("scheduler_args", {}))
                search_kw = dict(spec.get("search_args", {}))
                analysis = tune_run(
                    trainable, space,
                    metric=spec["metric"], mode=spec["mode"],
                    num_samples=int(spec.get("num_samples", 10)),
                    max_iterations=int(spec.get("max_iterations", 100)),
                    scheduler=SCHEDULERS[spec.get("scheduler", "fifo")](
                        **sched_kw),
                    search_alg=SEARCHERS[spec.get("search", "random")](
                        **search_kw),
                    max_concurrent=int(spec.get("max_concurrent", 4)),
                    # crash-resume knobs: how often trials snapshot
                    # (the resume point after an injected/real crash)
                    # and how many crashes a trial survives
                    checkpoint_freq=int(spec.get("checkpoint_freq", 5)),
                    max_failures=int(spec.get("max_failures", 2)),
                    verbose=verbose)

                # Trial.best_score is sign-internalized (higher is better);
                # persist the RAW metric value so status/results read
                # naturally. best_trial raises when every trial errored —
                # that must land in the 'failed' state too.
                sign = -1.0 if spec["mode"] == "min" else 1.0

                def raw(s):
                    return (None if s in (None, float("-inf"), float("inf"))
                            else float(sign * s))

                trials = [{
                    "trial_id": t.trial_id,
                    "config": t.config,
                    "status": t.status,
                    "iterations": t.iteration,
                    "best_score": raw(t.best_score),
                } for t in analysis.trials]
                state = {
                    "status": "done",
                    "ended_at": time.time(),
                    "best_config": analysis.best_config,
                    "best_score": raw(analysis.best_trial.best_score),
                    "n_trials": len(trials),
                    "trials": trials,
                }
        except BaseException as e:
            self._set_state_if_owner(name, my_lock,
                                     {"status": "failed",
                                      "error": repr(e),
                                      "ended_at": time.time()})
            self.kv.delete_if(_NS_LOCK, name, my_lock)
            raise
        # a displaced runner (someone force-took the lock) must write
        # NEITHER the lock nor the state — its results are unwanted.
        # The write is atomically guarded on still holding the lock
        # (put_if_other), so there is no check-then-write window.
        owns = self._set_state_if_owner(name, my_lock, state)
        self.kv.delete_if(_NS_LOCK, name, my_lock)
        if not owns:
            import sys
            print(f"[experiment] {name!r}: displaced by a forced "
                  "takeover; results not persisted", file=sys.stderr)
        return state

    def _run_via_service(self, name: str,
                         spec: Dict[str, Any]) -> Dict[str, Any]:
        from tosem_tpu_torch.tune.providers import SERVICES, run_with_service
        sched_name = spec.get("scheduler", "fifo")
        if sched_name not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {sched_name!r}")
        if sched_name == "pbt":
            # the service loop honors STOP verdicts only; PBT needs the
            # exploit/perturb directive path (save/restore through the
            # in-process Trainable contract) — running it here would be
            # a silent no-op degrading to random search
            raise ValueError(
                "training_service runs support stop-only schedulers "
                "(asha/median/hyperband/curvefit); use the in-process "
                "path for pbt")
        # the service loop streams intermediate metrics, so
        # early-stopping schedulers cancel RUNNING trials mid-flight
        scheduler = (None if sched_name == "fifo" else
                     SCHEDULERS[sched_name](
                         **dict(spec.get("scheduler_args", {}))))
        svc_name = spec["training_service"]
        if svc_name not in SERVICES:
            raise ValueError(
                f"unknown training_service {svc_name!r}; supported: "
                f"{sorted(SERVICES)} (NodeAgentService needs live agent "
                "endpoints — construct it directly and call "
                "run_with_service)")
        svc_cls = SERVICES[svc_name]
        svc_kw = {"max_concurrent": int(spec.get("max_concurrent", 4))}
        if svc_name == "subprocess":
            # the subprocess plane checkpoints trials for crash-resume;
            # the in-process LocalService has no crash boundary
            svc_kw["checkpoint_freq"] = int(spec.get("checkpoint_freq", 5))
        service = svc_cls(**svc_kw)
        try:
            out = run_with_service(
                spec["trainable"], space_from_json(spec["space"]),
                service=service, metric=spec["metric"],
                mode=spec["mode"],
                num_samples=int(spec.get("num_samples", 10)),
                max_iterations=int(spec.get("max_iterations", 100)),
                search_alg=SEARCHERS[spec.get("search", "random")](
                    **dict(spec.get("search_args", {}))),
                scheduler=scheduler,
                max_in_flight=int(spec.get("max_concurrent", 4)),
                timeout_s=float(spec.get("service_timeout_s", 600.0)))
        finally:
            service.shutdown()
        return {
            "status": "done",
            "ended_at": time.time(),
            "training_service": spec["training_service"],
            "best_config": out["best_config"],
            "best_score": out["best_score"],
            "n_trials": len(out["trials"]),
            "trials": [{
                "trial_id": t["trial_id"], "config": t["config"],
                "status": t["status"], "iterations": t["iterations"],
                "best_score": t["score"],
            } for t in out["trials"]],
        }

    def _set_state_if_owner(self, name: str, my_lock: bytes,
                            state: Dict[str, Any]) -> bool:
        blob = json.dumps(state, sort_keys=True, default=str).encode()
        return self.kv.put_if_other(_NS_STATE, name, blob,
                                    _NS_LOCK, name, my_lock)

    def _set_state(self, name: str, state: Dict[str, Any]) -> None:
        self.kv.put(_NS_STATE, name,
                    json.dumps(state, sort_keys=True, default=str).encode())
