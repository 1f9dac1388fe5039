"""Trial runner: ``tune.run`` over the distributed runtime.

The reference's trial-driving loop (``python/ray/tune/tune.py:57`` run,
``trial_runner.py:42,338`` step loop, ``ray_trial_executor.py:135`` actor
executor): trials run as runtime actors, a driver loop polls results with
``rt.wait``, feeds them to the scheduler (stop/continue/exploit) and the
search algorithm (observe), checkpoints trial state, and recovers failed
trials from their last checkpoint (``Trainable.save/restore`` contract,
``trainable.py``; elastic recovery per SURVEY §5.3).

The port's copy of ``tosem_tpu/tune/tune.py``: trials are actors of the
port's runtime (spawned workers once torch is loaded, so a trial actor
may take the card), ``slots_per_trial`` reserves the runtime's placement
bundles, and ``tune.step`` fires the port's chaos seam.
"""
from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import tosem_tpu_torch.runtime as rt
from tosem_tpu_torch.chaos import hooks as _chaos
from tosem_tpu_torch.tune.schedulers import (CONTINUE, STOP, FIFOScheduler,
                                             PBTScheduler, TrialScheduler)
from tosem_tpu_torch.tune.search import (GridSearch, GridValues, RandomSearch,
                                         SearchAlgorithm)

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


class Trainable:
    """Class trainable contract (``ray/tune/trainable.py`` shape):
    ``setup → step* → (save_state/load_state for PBT + failure recovery)``."""

    def __init__(self, config: Dict[str, Any]):
        self.config = dict(config)
        self.setup(self.config)

    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_state(self) -> Any:
        return None

    def load_state(self, state: Any) -> None:
        pass

    def reset_config(self, config: Dict[str, Any]) -> None:
        self.config = dict(config)


def _wrap_function(fn: Callable) -> type:
    """Adapt a generator-style function trainable (``def f(config): yield
    {...}``) to the class contract. No save/restore → recovery restarts it."""

    class _FnTrainable(Trainable):
        def setup(self, config):
            self._gen = fn(config)
            if not inspect.isgenerator(self._gen):
                raise TypeError("function trainables must be generators "
                                "yielding metric dicts")

        def step(self):
            return next(self._gen)

    _FnTrainable.__name__ = getattr(fn, "__name__", "fn") + "_trainable"
    return _FnTrainable


class _TrialActor:
    """Runs inside a runtime worker process: hosts one Trainable."""

    def __init__(self, trainable_cls, config):
        self._t = trainable_cls(config)
        self._it = 0

    def step(self):
        try:
            result = dict(self._t.step())
        except StopIteration:  # generator trainable ran out: natural end
            return {"__exhausted__": True, "training_iteration": self._it}
        self._it += 1
        result["training_iteration"] = self._it
        return result

    def save(self):
        return (self._it, self._t.config, self._t.save_state())

    def restore(self, snapshot):
        self._it, config, state = snapshot
        self._t.reset_config(config)
        self._t.load_state(state)

    def exploit(self, snapshot, new_config):
        _, _, state = snapshot           # donor weights, OUR iteration count
        self._t.load_state(state)
        self._t.reset_config(new_config)


@dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    status: str = PENDING
    iteration: int = 0
    last_result: Dict[str, Any] = field(default_factory=dict)
    best_score: float = float("-inf")
    reported_iter: int = 0          # high-water mark fed to schedulers
    failures: int = 0
    handle: Any = None
    step_ref: Any = None
    snapshot: Any = None                 # last known-good checkpoint
    pg: Any = None                       # placement-group bundle (if any)


class Analysis:
    def __init__(self, trials: List[Trial], metric: str, mode: str):
        self.trials = trials
        self.metric = metric
        self.mode = mode

    @property
    def best_trial(self) -> Trial:
        done = [t for t in self.trials if t.last_result]
        if not done:
            raise RuntimeError("no trial produced a result (all errored "
                               "before their first report)")
        return max(done, key=lambda t: t.best_score)

    @property
    def best_config(self) -> Dict[str, Any]:
        return self.best_trial.config

    @property
    def best_result(self) -> Dict[str, Any]:
        return self.best_trial.last_result

    def dataframe(self) -> List[Dict[str, Any]]:
        rows = []
        for t in self.trials:
            row = {"trial_id": t.trial_id, "status": t.status,
                   "iteration": t.iteration, **{f"config/{k}": v
                                                for k, v in t.config.items()},
                   **t.last_result}
            rows.append(row)
        return rows


def run(trainable, config_space: Dict[str, Any], *, metric: str, mode: str,
        num_samples: int = 10, max_iterations: int = 100,
        scheduler: Optional[TrialScheduler] = None,
        search_alg: Optional[SearchAlgorithm] = None,
        max_concurrent: int = 4, max_failures: int = 2,
        checkpoint_freq: int = 5,
        stop: Optional[Callable[[Dict[str, Any]], bool]] = None,
        slots_per_trial: int = 0,
        verbose: bool = False) -> Analysis:
    """Run an HPO experiment; returns an :class:`Analysis`.

    ``trainable``: a :class:`Trainable` subclass or a generator function.
    ``num_samples``: trial count (for pure grid search: grid size × samples).
    ``slots_per_trial``: when > 0, each trial atomically reserves a
    placement-group bundle of that many worker slots before launching (gang
    scheduling: concurrent distributed trials cannot half-acquire and
    deadlock); trials wait in PENDING while no bundle fits.
    """
    if mode not in ("min", "max"):
        raise ValueError("mode must be 'min' or 'max'")
    trainable_cls = (trainable if inspect.isclass(trainable)
                     else _wrap_function(trainable))
    scheduler = scheduler or FIFOScheduler()
    scheduler.set_mode(metric, mode)
    if search_alg is None:
        has_grid = any(isinstance(v, GridValues)
                       for v in config_space.values())
        search_alg = GridSearch() if has_grid else RandomSearch()
    search_alg.set_space(config_space, mode)
    # older/user suggesters may define observe(config, score) without the
    # budget kwarg — detect once and call compatibly
    _observe_params = inspect.signature(search_alg.observe).parameters
    _wants_budget = ("budget" in _observe_params
                     or any(p.kind is inspect.Parameter.VAR_KEYWORD
                            for p in _observe_params.values()))
    if isinstance(search_alg, GridSearch):
        num_samples = max(num_samples, search_alg.grid_size())

    own_runtime = not rt.is_initialized()
    if own_runtime:
        rt.init(num_workers=max_concurrent)
    actor_cls = rt.remote(_TrialActor)

    # Trials are created LAZILY so adaptive suggesters (TPE, evolution) see
    # the results of earlier trials before proposing later configs.
    trials: List[Trial] = []
    created = 0
    running: List[Trial] = []
    sign = -1.0 if mode == "min" else 1.0

    def next_trial() -> Trial:
        nonlocal created
        t = Trial(trial_id=f"t{created:04d}", config=search_alg.suggest())
        created += 1
        trials.append(t)
        if isinstance(scheduler, PBTScheduler):
            scheduler.register_config(t.trial_id, t.config)
        return t

    def acquire_bundle() -> Any:
        """Try-acquire a gang bundle for one trial (non-blocking: the
        driver loop must keep polling running trials, so a trial that
        cannot get its bundle now simply stays unlaunched)."""
        if not slots_per_trial:
            return None
        try:
            return rt.placement_group(slots_per_trial, timeout=0)
        except rt.PlacementTimeout:
            return False

    def launch(t: Trial, restore: bool = False):
        cls = (actor_cls.options(placement_group=t.pg)
               if t.pg else actor_cls)
        t.handle = cls.remote(trainable_cls, t.config)
        if restore and t.snapshot is not None:
            rt.get(t.handle.restore.remote(t.snapshot))
            if verbose:
                print(f"[tune] {t.trial_id} restored at iter {t.iteration}")
        t.status = RUNNING
        t.step_ref = t.handle.step.remote()

    def finish(t: Trial, status: str):
        t.status = status
        if t.handle is not None:
            rt.kill(t.handle)
            t.handle = None
        if t.pg:
            t.pg.remove()
            t.pg = None
        t.step_ref = None
        running.remove(t)
        scheduler.on_complete(t.trial_id)

    while created < num_samples or running:
        while created < num_samples and len(running) < max_concurrent:
            bundle = acquire_bundle()
            if bundle is False:
                if not running:
                    time.sleep(0.25)     # bundles held elsewhere: back off
                break                    # no free bundle: retry next tick
            t = next_trial()
            t.pg = bundle
            launch(t)
            running.append(t)
        refs = [t.step_ref for t in running]
        done, _ = rt.wait(refs, num_returns=1, timeout=30.0)
        if not done:
            continue
        by_ref = {t.step_ref: t for t in running}
        for ref in done:
            t = by_ref[ref]
            try:
                result = rt.get(ref)
            except (rt.TaskError,) as e:
                t.status = ERROR
                t.failures += 1
                if verbose:
                    print(f"[tune] {t.trial_id} errored: {e}")
                finish(t, ERROR)
                continue
            except (rt.ActorDiedError, rt.WorkerCrashedError):
                t.failures += 1
                if t.failures <= max_failures:
                    # elastic recovery: relaunch from last checkpoint
                    # (torch_trainer.py:323 _resize_worker_group analog)
                    if verbose:
                        print(f"[tune] {t.trial_id} died; relaunching "
                              f"({t.failures}/{max_failures})")
                    launch(t, restore=True)
                else:
                    finish(t, ERROR)
                continue
            if result.get("__exhausted__"):
                finish(t, TERMINATED)
                continue
            t.iteration = result["training_iteration"]
            t.last_result = result
            act = _chaos.fire("tune.step", target=t.trial_id,
                              iteration=t.iteration)
            if act is not None and act["action"] == "crash_trial":
                # chaos: SIGKILL the trial's actor process between
                # checkpoints; the next step errors with ActorDiedError
                # and the recovery path below relaunches the trial from
                # its last snapshot (resume, not restart)
                from tosem_tpu_torch.chaos.injector import crash_actor_process
                crash_actor_process(t.handle._actor_id)
            score = sign * float(result[metric])
            t.best_score = max(t.best_score, score)
            if t.iteration <= t.reported_iter:
                # replayed iteration after checkpoint-restore: don't feed
                # schedulers/search twice (rung scores would be corrupted)
                t.step_ref = t.handle.step.remote()
                continue
            t.reported_iter = t.iteration
            if _wants_budget:
                search_alg.observe(t.config, float(result[metric]),
                                   budget=t.iteration)
            else:
                search_alg.observe(t.config, float(result[metric]))
            decision = scheduler.on_result(t.trial_id, t.iteration, result)
            if stop is not None and stop(result):
                decision = STOP
            if t.iteration >= max_iterations:
                decision = STOP
            if decision == STOP:
                finish(t, TERMINATED)
                continue
            # periodic checkpoint for failure recovery + PBT exploit
            # source. copy=True: the snapshot is RETAINED for the
            # trial's lifetime — a mapped read would pin store capacity
            # per live trial and starve later puts
            if checkpoint_freq and t.iteration % checkpoint_freq == 0:
                try:
                    t.snapshot = rt.get(t.handle.save.remote(), copy=True)
                except Exception:
                    pass
            directive = None
            if isinstance(scheduler, PBTScheduler) and \
                    t.iteration % scheduler.interval == 0:
                directive = scheduler.exploit_directive(t.trial_id)
            if directive is not None:
                donor = next((d for d in trials
                              if d.trial_id == directive["donor"]), None)
                donor_snap = donor.snapshot if donor else None
                if donor_snap is not None:
                    rt.get(t.handle.exploit.remote(donor_snap,
                                                   directive["config"]))
                    t.config = dict(directive["config"])
                    if verbose:
                        print(f"[tune] {t.trial_id} exploits "
                              f"{directive['donor']}")
            t.step_ref = t.handle.step.remote()
    if own_runtime:
        rt.shutdown()
    return Analysis(trials, metric, mode)
