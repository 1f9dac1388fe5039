"""Trial schedulers: FIFO, ASHA, median stopping, PBT.

The reference's scheduler surface (SURVEY §2.1: ``python/ray/tune/
schedulers/`` — ASHA/HyperBand/PBT; §2.4: NNI ``medianstop_assessor.py``,
``pbt_tuner.py``). A scheduler sees every reported result and decides
CONTINUE/STOP; PBT additionally issues exploit directives (clone a better
trial's checkpoint, perturb its config) which the trial runner executes via
the Trainable save/restore contract.

The port's copy of ``tosem_tpu/tune/schedulers.py``.
"""
from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np


def _rung_decision(scores: List[float], s: float, rf: int) -> str:
    """Shared async-successive-halving rule: record ``s`` at the rung and
    keep it only if it sits in the running top ``1/rf``."""
    scores.append(s)
    k = max(1, int(math.ceil(len(scores) / rf)))
    cutoff = sorted(scores, reverse=True)[k - 1]
    return CONTINUE if s >= cutoff else STOP

CONTINUE = "continue"
STOP = "stop"


class TrialScheduler:
    def set_mode(self, metric: str, mode: str) -> None:
        self.metric = metric
        self.mode = mode

    def _score(self, result: Dict[str, Any]) -> float:
        v = float(result[self.metric])
        return -v if self.mode == "min" else v

    def on_result(self, trial_id: str, iteration: int,
                  result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_complete(self, trial_id: str) -> None:
        pass

    def exploit_directive(self, trial_id: str) -> Optional[Dict[str, Any]]:
        """PBT hook: non-None → {'donor': id, 'config': new_config}."""
        return None


class FIFOScheduler(TrialScheduler):
    pass


class ASHAScheduler(TrialScheduler):
    """Asynchronous successive halving (Tune `ASHAScheduler` role).

    Rungs at ``grace_period * reduction_factor**k``; when a trial reaches a
    rung it is stopped unless its score is in the top ``1/reduction_factor``
    of everything recorded at that rung so far.
    """

    def __init__(self, max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 3):
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        self.rung_scores: Dict[int, List[float]] = defaultdict(list)

    def on_result(self, trial_id, iteration, result):
        s = self._score(result)
        if iteration >= self.max_t:
            return STOP
        if iteration not in self.rungs:
            return CONTINUE
        return _rung_decision(self.rung_scores[iteration], s, self.rf)


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running-average score at step t is below the median
    of other trials' running averages at t (NNI medianstop_assessor role)."""

    def __init__(self, grace_period: int = 5, min_samples: int = 3):
        self.grace = grace_period
        self.min_samples = min_samples
        self.avg: Dict[str, List[float]] = defaultdict(list)  # running sums

    def on_result(self, trial_id, iteration, result):
        s = self._score(result)
        hist = self.avg[trial_id]
        hist.append(s)
        if iteration < self.grace:
            return CONTINUE
        my_avg = sum(hist) / len(hist)
        others = [sum(h[:len(hist)]) / min(len(h), len(hist))
                  for tid, h in self.avg.items()
                  if tid != trial_id and len(h) >= len(hist)]
        if len(others) < self.min_samples:
            return CONTINUE
        others_sorted = sorted(others)
        median = others_sorted[len(others_sorted) // 2]
        return STOP if my_avg < median else CONTINUE


class PBTScheduler(TrialScheduler):
    """Population-based training (Tune ``pbt.py`` / NNI ``pbt_tuner.py``).

    Every ``perturbation_interval`` iterations, a trial in the bottom
    quantile exploits one in the top quantile: the runner clones the donor's
    checkpoint and perturbs the config (×0.8 / ×1.25 or resample).
    """

    def __init__(self, hyperparam_mutations: Dict[str, Any],
                 perturbation_interval: int = 5,
                 quantile_fraction: float = 0.25,
                 seed: Optional[int] = None):
        self.mutations = hyperparam_mutations
        self.interval = perturbation_interval
        self.quantile = quantile_fraction
        self.rng = random.Random(seed)
        self.latest: Dict[str, float] = {}
        self.configs: Dict[str, Dict[str, Any]] = {}
        self.last_perturb: Dict[str, int] = defaultdict(int)

    def register_config(self, trial_id: str, config: Dict[str, Any]) -> None:
        self.configs[trial_id] = dict(config)

    def on_result(self, trial_id, iteration, result):
        self.latest[trial_id] = self._score(result)
        return CONTINUE

    def exploit_directive(self, trial_id):
        if trial_id not in self.latest or len(self.latest) < 4:
            return None
        ranked = sorted(self.latest, key=self.latest.get, reverse=True)
        k = max(1, int(len(ranked) * self.quantile))
        bottom = set(ranked[-k:])
        if trial_id not in bottom:
            return None
        donor = self.rng.choice(ranked[:k])
        if donor == trial_id:
            return None
        new_cfg = dict(self.configs.get(donor, {}))
        for key, spec in self.mutations.items():
            if isinstance(spec, list):
                new_cfg[key] = self.rng.choice(spec)
            elif callable(spec):
                new_cfg[key] = spec()
            elif key in new_cfg:
                factor = self.rng.choice([0.8, 1.25])
                new_cfg[key] = new_cfg[key] * factor
        self.configs[trial_id] = new_cfg
        return {"donor": donor, "config": new_cfg}


class HyperBandScheduler(TrialScheduler):
    """HyperBand: several successive-halving brackets run side by side.

    The bracket half of the reference's BOHB advisor
    (``nni/algorithms/hpo/bohb_advisor/``; Tune ``hyperband.py``): bracket
    ``s`` starts trials at ``grace * rf**s`` and halves at every rung up to
    ``max_t``, so aggressive early stopping and conservative full runs
    coexist. Trials are assigned to brackets round-robin at first report.
    """

    def __init__(self, max_t: int = 81, reduction_factor: int = 3,
                 grace_period: int = 1):
        self.max_t = max_t
        self.rf = reduction_factor
        self.grace = grace_period
        s_max = 0
        t = grace_period
        while t * reduction_factor <= max_t:
            t *= reduction_factor
            s_max += 1
        # bracket s: rungs at grace*rf^s, grace*rf^(s+1), ..., max_t
        self.brackets: List[List[int]] = []
        for s in range(s_max + 1):
            rungs = []
            t = grace_period * (reduction_factor ** s)
            while t < max_t:
                rungs.append(t)
                t *= reduction_factor
            self.brackets.append(rungs)
        self.assignment: Dict[str, int] = {}
        self._next_bracket = 0
        self.rung_scores: Dict[tuple, List[float]] = defaultdict(list)

    def on_result(self, trial_id, iteration, result):
        if trial_id not in self.assignment:
            self.assignment[trial_id] = self._next_bracket
            self._next_bracket = (self._next_bracket + 1) % len(
                self.brackets)
        b = self.assignment[trial_id]
        s = self._score(result)
        if iteration >= self.max_t:
            return STOP
        if iteration not in self.brackets[b]:
            return CONTINUE
        return _rung_decision(self.rung_scores[(b, iteration)], s, self.rf)


class CurveFittingAssessor(TrialScheduler):
    """Learning-curve extrapolation stopper.

    The reference's ``nni/algorithms/hpo/curvefitting_assessor/`` fits a
    parametric model ensemble to the partial metric history and stops the
    trial when the PREDICTED final value cannot beat the best final seen.
    Here: least-squares fits of two saturating families —
    ``y = a - b * exp(-c t)`` and ``y = a - b * t**-c`` — over a coarse
    ``c`` grid (each fit is then linear in a, b), averaged into one
    prediction at ``target_iteration``.
    """

    def __init__(self, target_iteration: int = 100, grace_period: int = 6,
                 margin: float = 0.02, min_completed: int = 1):
        self.target = target_iteration
        self.grace = grace_period
        self.margin = margin
        self.min_completed = min_completed
        self.hist: Dict[str, List[float]] = defaultdict(list)
        self.finals: List[float] = []

    def predict_final(self, ys: List[float]) -> float:
        t = np.arange(1, len(ys) + 1, dtype=float)
        y = np.asarray(ys, float)
        fits = []   # (sse, prediction) per family — combined by fit quality
        for basis in ("exp", "pow"):
            best = None
            for c in (0.01, 0.03, 0.1, 0.3, 1.0):
                f = np.exp(-c * t) if basis == "exp" else t ** (-c)
                A = np.stack([np.ones_like(t), -f], 1)
                coef, res, _, _ = np.linalg.lstsq(A, y, rcond=None)
                sse = float(((A @ coef - y) ** 2).sum())
                if best is None or sse < best[0]:
                    ft = (math.exp(-c * self.target) if basis == "exp"
                          else self.target ** (-c))
                    best = (sse, coef[0] - coef[1] * ft)
            fits.append(best)
        # inverse-SSE weighting: a family that fits the history an order of
        # magnitude better should dominate the extrapolation
        ws = [1.0 / (sse + 1e-12) for sse, _ in fits]
        return float(sum(w * p for w, (_, p) in zip(ws, fits)) / sum(ws))

    def on_result(self, trial_id, iteration, result):
        s = self._score(result)
        self.hist[trial_id].append(s)
        if iteration >= self.target:
            self.finals.append(s)
            return STOP
        if (iteration < self.grace
                or len(self.finals) < self.min_completed):
            return CONTINUE
        pred = self.predict_final(self.hist[trial_id])
        best_final = max(self.finals)
        span = abs(best_final) + 1e-9
        if pred < best_final - self.margin * span:
            self.finals.append(s)   # record truncated final for reference
            return STOP
        return CONTINUE

    def on_complete(self, trial_id):
        h = self.hist.get(trial_id)
        if h:
            self.finals.append(h[-1])
