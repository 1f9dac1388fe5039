"""Tests for the advanced HPO layer: GP-BO, BOHB, HyperBand, curve fitting.

Reference style (SURVEY §4.4, NNI ``test/ut/sdk``): suggester quality on
synthetic objectives (model-based must beat random at equal budget),
bracket/assessor decision checks with hand-computable histories, and an
end-to-end ``tune.run`` integration on a fast synthetic trainable.

A copy of ``tests/test_hpo_advanced.py`` against the port's ``tune/``,
with ``tests/test_placement.py``'s ``TestTuneBundles`` (trials that
gang-reserve slots of the port's runtime). The trainables ship by value,
so a spawned worker never imports this module.
"""
import math
import random
import sys

import cloudpickle
import numpy as np
import pytest

import tosem_tpu_torch.runtime as rt
from tosem_tpu_torch.tune import (BOHBSearch, CurveFittingAssessor, GPSearch,
                                  HyperBandScheduler, RandomSearch, uniform,
                                  choice)

cloudpickle.register_pickle_by_value(sys.modules[__name__])


def quadratic(cfg):
    """Smooth 2-d objective, max 1.0 at (0.3, 0.7)."""
    return 1.0 - (cfg["x"] - 0.3) ** 2 - (cfg["y"] - 0.7) ** 2


SPACE = {"x": uniform(0, 1), "y": uniform(0, 1)}


def run_suggester(alg, n, budget_key=False, seed=None):
    alg.set_space(dict(SPACE), "max")
    best = -1e9
    for _ in range(n):
        cfg = alg.suggest()
        s = quadratic(cfg)
        if budget_key:
            alg.observe(cfg, s, budget=10)
        else:
            alg.observe(cfg, s)
        best = max(best, s)
    return best


class TestGPSearch:
    def test_beats_random_at_equal_budget(self):
        gp_best = np.mean([run_suggester(GPSearch(seed=s), 40)
                           for s in range(3)])
        rnd_best = np.mean([run_suggester(RandomSearch(seed=s), 40)
                            for s in range(3)])
        assert gp_best >= rnd_best - 1e-6
        assert gp_best > 0.985         # converges near the optimum

    def test_handles_categoricals(self):
        space = {"x": uniform(0, 1), "opt": choice(["a", "b", "c"])}

        def obj(cfg):
            bonus = {"a": 0.0, "b": 0.3, "c": 0.1}[cfg["opt"]]
            return bonus - (cfg["x"] - 0.5) ** 2

        alg = GPSearch(seed=0, n_startup=6)
        alg.set_space(space, "max")
        for _ in range(30):
            cfg = alg.suggest()
            alg.observe(cfg, obj(cfg))
        # after the model kicks in, it should prefer option "b"
        picks = [alg.suggest()["opt"] for _ in range(10)]
        assert picks.count("b") >= 5, picks

    def test_min_mode(self):
        alg = GPSearch(seed=1, n_startup=5)
        alg.set_space(dict(SPACE), "min")
        for _ in range(30):
            cfg = alg.suggest()
            alg.observe(cfg, (cfg["x"] - 0.2) ** 2 + (cfg["y"] - 0.2) ** 2)
        final = alg.suggest()
        assert abs(final["x"] - 0.2) < 0.25
        assert abs(final["y"] - 0.2) < 0.25


class TestBOHB:
    def test_model_concentrates_on_good_region(self):
        alg = BOHBSearch(seed=0, min_points=8, random_fraction=0.0)
        alg.set_space(dict(SPACE), "max")
        rng = random.Random(0)
        for _ in range(30):
            cfg = {"x": rng.random(), "y": rng.random()}
            alg.observe(cfg, quadratic(cfg), budget=9)
        sugg = [alg.suggest() for _ in range(20)]
        dist = np.mean([math.hypot(c["x"] - 0.3, c["y"] - 0.7)
                        for c in sugg])
        assert dist < 0.35, dist       # near the optimum, not uniform (~0.44)

    def test_uses_highest_populated_budget(self):
        alg = BOHBSearch(seed=0, min_points=4)
        alg.set_space(dict(SPACE), "max")
        for i in range(6):
            alg.observe({"x": 0.1, "y": 0.1}, 0.0, budget=1)
        assert alg._model_budget() == 1.0
        for i in range(4):
            alg.observe({"x": 0.9, "y": 0.9}, 1.0, budget=27)
        assert alg._model_budget() == 27.0

    def test_decode_roundtrip_with_choice(self):
        space = {"x": uniform(0, 1), "opt": choice(["a", "b"])}
        alg = BOHBSearch(seed=0, min_points=2, random_fraction=0.0)
        alg.set_space(space, "max")
        for v, s in [("a", 1.0), ("a", 0.9), ("b", 0.0), ("b", 0.1)]:
            alg.observe({"x": 0.5, "opt": v}, s, budget=3)
        cfg = alg.suggest()
        assert set(cfg) == {"x", "opt"}
        assert cfg["opt"] in ("a", "b")
        assert 0.0 <= cfg["x"] <= 1.0


class TestHyperBand:
    def _res(self, v):
        return {"score": v}

    def test_brackets_have_decreasing_rungs(self):
        hb = HyperBandScheduler(max_t=27, reduction_factor=3,
                                grace_period=1)
        assert hb.brackets[0] == [1, 3, 9]
        assert hb.brackets[1] == [3, 9]
        assert hb.brackets[2] == [9]

    def test_bad_trial_stopped_at_rung_good_survives(self):
        hb = HyperBandScheduler(max_t=27, reduction_factor=3,
                                grace_period=1)
        hb.set_mode("score", "max")
        # pin all trials to bracket 0 by pre-assigning
        for tid in ("a", "b", "c"):
            hb.assignment[tid] = 0
        # async halving: each arrival compares to the rung's running top-1/rf
        assert hb.on_result("a", 1, self._res(0.8)) == "continue"
        assert hb.on_result("b", 1, self._res(0.9)) == "continue"
        assert hb.on_result("c", 1, self._res(0.1)) == "stop"

    def test_round_robin_bracket_assignment(self):
        hb = HyperBandScheduler(max_t=27)
        hb.set_mode("score", "max")
        n = len(hb.brackets)
        assert hb.brackets[-1] == []      # most conservative: no halving
        for i in range(n + 1):
            hb.on_result(f"t{i}", 2, self._res(0.5))
        assert hb.assignment["t0"] == 0
        assert hb.assignment["t1"] == 1
        assert hb.assignment[f"t{n}"] == 0   # wraps around


class TestCurveFitting:
    def test_predicts_saturating_curve(self):
        cf = CurveFittingAssessor(target_iteration=100)
        ys = [1.0 - math.exp(-0.1 * t) for t in range(1, 21)]
        pred = cf.predict_final(ys)
        assert abs(pred - 1.0) < 0.1

    def test_stops_hopeless_trial_keeps_promising(self):
        cf = CurveFittingAssessor(target_iteration=50, grace_period=6,
                                  margin=0.05)
        cf.set_mode("acc", "max")
        # one completed strong trial establishes the bar
        for t in range(1, 51):
            cf.on_result("good", t, {"acc": 1.0 - math.exp(-0.2 * t)})
        decisions = []
        for t in range(1, 21):
            # saturates far below the bar
            d = cf.on_result("bad", t, {"acc": 0.3 - 0.3 *
                                        math.exp(-0.3 * t)})
            decisions.append(d)
            if d == "stop":
                break
        assert "stop" in decisions
        # a trial tracking the winner's curve is kept through 20 iters
        cf2 = CurveFittingAssessor(target_iteration=50, grace_period=6,
                                   margin=0.05)
        cf2.set_mode("acc", "max")
        for t in range(1, 51):
            cf2.on_result("good", t, {"acc": 1.0 - math.exp(-0.2 * t)})
        for t in range(1, 21):
            d = cf2.on_result("also_good", t,
                              {"acc": 0.98 * (1.0 - math.exp(-0.18 * t))})
            assert d == "continue", t


class TestTuneIntegration:
    def test_bohb_with_hyperband_end_to_end(self):
        from tosem_tpu_torch.tune import run

        def trainable(config):
            # converges toward quadratic(config); iteration-dependent
            for t in range(1, 28):
                target = quadratic(config)
                yield {"score": target * (1 - math.exp(-0.3 * t))}

        analysis = run(trainable, dict(SPACE), metric="score", mode="max",
                       num_samples=12, max_iterations=27,
                       scheduler=HyperBandScheduler(max_t=27),
                       search_alg=BOHBSearch(seed=0, min_points=6),
                       max_concurrent=3)
        assert analysis.best_result["score"] > 0.7


class TestTuneBundles:
    def test_trials_request_bundles(self):
        """Tune trials gang-reserve their slots; concurrency is bounded
        by bundle availability and all bundles are released at the end."""
        from tosem_tpu_torch import tune

        def trainable(config):
            for i in range(3):
                yield {"loss": config["x"] * (3 - i)}

        rt.init(num_workers=4)
        try:
            analysis = tune.run(
                trainable, {"x": tune.uniform(0.1, 1.0)},
                metric="loss", mode="min", num_samples=4,
                max_iterations=3, max_concurrent=2, slots_per_trial=2)
            assert len(analysis.trials) == 4
            assert all(t.status in ("TERMINATED",)
                       for t in analysis.trials)
            workers = rt.api._runtime.task_workers
            assert all(w.reserved_by is None and not w.parked
                       for w in workers)
        finally:
            rt.shutdown()
