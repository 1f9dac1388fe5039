"""Tests for the HPO layer (search, schedulers, trial runner, recovery).

Mirrors the reference's Tune/NNI testing style (SURVEY §4.1, §4.4): toy
objective functions, scheduler unit behavior, and a PBT + fault-injection
run in the spirit of ``release/long_running_distributed_tests/workloads/
pytorch_pbt_failure.py``.

A copy of ``tests/test_tune.py`` against the port's ``tune/`` on the
port's runtime. Trials are actors in spawned workers once torch is
loaded, so this module ships its trainables by value
(``cloudpickle.register_pickle_by_value``) and a worker never imports
it.
"""
import os
import random
import sys

import cloudpickle
import pytest

import tosem_tpu_torch.runtime as rt
from tosem_tpu_torch import tune

cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module")
def runtime():
    rt.init(num_workers=4)
    yield rt
    rt.shutdown()


def quadratic(config):
    """Converging toy objective: loss → (x-3)^2 as iterations grow."""
    for i in range(1, 31):
        yield {"loss": (config["x"] - 3.0) ** 2 + 10.0 / i}


class TestSearchSpaces:
    def test_domains_sample_in_range(self):
        rng = random.Random(0)
        assert -1 <= tune.uniform(-1, 1).sample(rng) <= 1
        v = tune.loguniform(1e-4, 1e-1).sample(rng)
        assert 1e-4 <= v <= 1e-1
        assert tune.randint(2, 5).sample(rng) in (2, 3, 4)
        assert tune.choice(["a", "b"]).sample(rng) in ("a", "b")

    def test_tpe_converges_better_than_chance(self):
        # 1-D quadratic: after observing, TPE should suggest near the optimum
        alg = tune.TPESearch(seed=0, n_startup=8)
        alg.set_space({"x": tune.uniform(-10, 10)}, "min")
        rng = random.Random(1)
        for _ in range(40):
            cfg = alg.suggest()
            alg.observe(cfg, (cfg["x"] - 3.0) ** 2)
        final = [alg.suggest()["x"] for _ in range(10)]
        mean = sum(final) / len(final)
        assert abs(mean - 3.0) < 2.5

    def test_evolution_improves(self):
        alg = tune.EvolutionSearch(seed=0, population=8)
        alg.set_space({"x": tune.uniform(-10, 10)}, "min")
        best = float("inf")
        for _ in range(60):
            cfg = alg.suggest()
            score = (cfg["x"] - 3.0) ** 2
            best = min(best, score)
            alg.observe(cfg, score)
        assert best < 0.5


class TestSchedulers:
    def test_asha_stops_bad_trials(self):
        sched = tune.ASHAScheduler(max_t=27, grace_period=1,
                                   reduction_factor=3)
        sched.set_mode("loss", "min")
        # good trial reaches rungs first (sets the bar)
        for it in (1, 3, 9):
            assert sched.on_result("good", it, {"loss": 0.1}) == "continue"
        decisions = [sched.on_result("bad", it, {"loss": 10.0})
                     for it in (1, 3, 9)]
        assert "stop" in decisions

    def test_median_stopping(self):
        sched = tune.MedianStoppingRule(grace_period=3, min_samples=2)
        sched.set_mode("acc", "max")
        for tid, acc in [("a", 0.9), ("b", 0.8), ("c", 0.85)]:
            for it in range(1, 7):
                sched.on_result(tid, it, {"acc": acc})
        out = [sched.on_result("lame", it, {"acc": 0.1})
               for it in range(1, 7)]
        assert "stop" in out

    def test_pbt_exploits_bottom_quantile(self):
        sched = tune.PBTScheduler({"lr": [0.1, 0.01]},
                                  perturbation_interval=1, seed=0)
        sched.set_mode("acc", "max")
        for tid, acc in [("a", 0.9), ("b", 0.8), ("c", 0.7), ("d", 0.1)]:
            sched.register_config(tid, {"lr": 0.05})
            sched.on_result(tid, 1, {"acc": acc})
        assert sched.exploit_directive("a") is None     # top stays
        d = sched.exploit_directive("d")                # bottom exploits
        assert d is not None and d["donor"] == "a"
        assert d["config"]["lr"] in (0.1, 0.01)


class TestRun:
    def test_random_search_finds_minimum(self, runtime):
        analysis = tune.run(quadratic, {"x": tune.uniform(-10, 10)},
                            metric="loss", mode="min", num_samples=12,
                            max_iterations=20, max_concurrent=4,
                            search_alg=tune.RandomSearch(seed=0))
        assert analysis.best_result["loss"] < 15.0
        assert len(analysis.trials) == 12
        assert all(t.status == "TERMINATED" for t in analysis.trials)

    def test_grid_search_covers_grid(self, runtime):
        seen = []

        def record(config):
            yield {"loss": config["x"] ** 2, "x": config["x"]}

        analysis = tune.run(record, {"x": tune.grid_search([1, 2, 3, 4])},
                            metric="loss", mode="min", num_samples=1,
                            max_iterations=3)
        xs = sorted(t.config["x"] for t in analysis.trials)
        assert xs == [1, 2, 3, 4]
        assert analysis.best_config["x"] == 1

    def test_asha_run_terminates_early(self, runtime):
        analysis = tune.run(quadratic, {"x": tune.uniform(-10, 10)},
                            metric="loss", mode="min", num_samples=10,
                            max_iterations=27,
                            scheduler=tune.ASHAScheduler(
                                max_t=27, grace_period=1,
                                reduction_factor=3),
                            search_alg=tune.RandomSearch(seed=1))
        iters = [t.iteration for t in analysis.trials]
        assert min(iters) < 27          # some trials culled early
        assert analysis.best_result["loss"] < 20.0

    def test_stop_predicate(self, runtime):
        analysis = tune.run(quadratic, {"x": tune.uniform(2.9, 3.1)},
                            metric="loss", mode="min", num_samples=2,
                            max_iterations=30,
                            stop=lambda r: r["loss"] < 1.2)
        assert all(t.iteration < 30 for t in analysis.trials)


class TestAdaptivity:
    def test_suggester_sees_results_of_earlier_trials(self, runtime):
        # trials must be created lazily: later suggest() calls observe
        # earlier results (otherwise TPE/evolution degrade to random)
        seen = []

        class Spy(tune.RandomSearch):
            def suggest(self):
                seen.append(len(self.obs) if hasattr(self, "obs") else
                            len(getattr(self, "_observed", [])))
                return super().suggest()

            def observe(self, config, score):
                self._observed = getattr(self, "_observed", []) + [score]

        analysis = tune.run(quadratic, {"x": tune.uniform(-10, 10)},
                            metric="loss", mode="min", num_samples=8,
                            max_iterations=3, max_concurrent=2,
                            search_alg=Spy(seed=0))
        assert len(analysis.trials) == 8
        assert seen[-1] > 0     # last suggestion saw earlier observations


class _CountingTrainable(tune.Trainable):
    """Class trainable with real state: counts steps, supports save/load."""

    def setup(self, config):
        self.x = config["x"]
        self.steps = 0

    def step(self):
        self.steps += 1
        if self.steps == 3 and self.config.get("crash_once") and \
                not os.path.exists(self.config["marker"]):
            open(self.config["marker"], "w").close()
            os._exit(1)
        return {"loss": (self.x - 3.0) ** 2 + 10.0 / self.steps,
                "steps_state": self.steps}

    def save_state(self):
        return {"steps": self.steps}

    def load_state(self, state):
        self.steps = state["steps"]


class TestFaultRecovery:
    def test_trial_recovers_from_checkpoint(self, runtime, tmp_path):
        marker = str(tmp_path / "crashed")
        analysis = tune.run(
            _CountingTrainable,
            {"x": 3.0, "crash_once": True, "marker": marker},
            metric="loss", mode="min", num_samples=1, max_iterations=8,
            checkpoint_freq=2, max_failures=2)
        t = analysis.trials[0]
        assert t.status == "TERMINATED"
        assert t.failures == 1
        assert os.path.exists(marker)
        # state restored from iter-2 checkpoint, then continued to 8
        assert t.last_result["steps_state"] == 8

    def test_failures_exhausted_marks_error(self, runtime):
        class AlwaysDie(tune.Trainable):
            def step(self):
                os._exit(1)

        analysis = tune.run(AlwaysDie, {}, metric="loss", mode="min",
                            num_samples=1, max_iterations=5, max_failures=1)
        assert analysis.trials[0].status == "ERROR"


class TestPBTRun:
    def test_pbt_propagates_good_config(self, runtime):
        # lr=good converges fast; PBT should clone it into bad trials
        def lr_trainable(config):
            acc = 0.0
            for i in range(40):
                acc += config["lr"] * 0.1          # good lr climbs faster
                yield {"acc": acc, "lr_seen": config["lr"]}

        sched = tune.PBTScheduler({"lr": [0.01, 1.0]},
                                  perturbation_interval=3,
                                  quantile_fraction=0.34, seed=2)
        analysis = tune.run(lr_trainable,
                            {"lr": tune.choice([0.01, 0.02, 1.0, 0.9])},
                            metric="acc", mode="max", num_samples=6,
                            max_iterations=20, scheduler=sched,
                            search_alg=tune.RandomSearch(seed=3),
                            checkpoint_freq=3, max_concurrent=6)
        assert analysis.best_result["acc"] > 1.0
