"""The port's HPO plane held to the JAX package's, decision for decision.

Every searcher, from the same seed and fed the same results, suggests the
same configs in both packages; every scheduler gives the same decisions
(and PBT the same exploit directives) on the same stream of results.
The port's plane stands alone: importing it loads neither JAX nor the
JAX package, a trial worker is the port's own module, and the agents'
import of the worker loads no numpy. Last, the JAX package's ``hpo_cli
results`` fails after a training-service run, where the port's rows
carry ``iterations`` (ROADMAP.md C-ref16).
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPACE = {"x": {"type": "uniform", "low": -5.0, "high": 5.0},
         "lr": {"type": "loguniform", "low": 1e-4, "high": 1e-1},
         "n": {"type": "randint", "low": 1, "high": 8},
         "opt": {"type": "choice", "values": ["a", "b", "c"]},
         "fixed": 7}
GRID_SPACE = {"x": {"type": "grid", "values": [1, 2, 3]},
              "opt": {"type": "grid", "values": ["a", "b"]},
              "lr": {"type": "loguniform", "low": 1e-4, "high": 1e-1}}
SEARCHERS = {"random": {}, "grid": {}, "tpe": {"n_startup": 6},
             "evolution": {"population": 6}, "gp": {"n_startup": 5},
             "bohb": {"min_points": 5}, "pso": {"n_particles": 5}}


def _objective(cfg):
    bonus = {"a": 0.0, "b": 0.4, "c": 0.1}[cfg["opt"]]
    return ((cfg["x"] - 1.0) ** 2 + (math.log10(cfg["lr"]) + 2.5) ** 2
            + 0.1 * cfg.get("n", 0) - bonus)


def _suggestions(pkg, name, mode, n=24):
    import importlib
    exp = importlib.import_module(f"{pkg}.tune.experiment")
    alg = exp.SEARCHERS[name](seed=3, **SEARCHERS[name])
    space = GRID_SPACE if name == "grid" else SPACE
    alg.set_space(exp.space_from_json(space), mode)
    out = []
    for i in range(n):
        cfg = alg.suggest()
        score = _objective(cfg)
        alg.observe(cfg, score, budget=(1, 3, 9)[i % 3])
        out.append(cfg)
    return out


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("name", sorted(SEARCHERS))
def test_searcher_suggests_the_reference_s_configs(name, mode):
    ours = _suggestions("tosem_tpu_torch", name, mode)
    theirs = _suggestions("tosem_tpu", name, mode)
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs,
                                                          sort_keys=True)
    assert len({json.dumps(c, sort_keys=True) for c in ours}) > 1


SCHEDULERS = {
    "fifo": {},
    "asha": {"max_t": 27, "grace_period": 1, "reduction_factor": 3},
    "median": {"grace_period": 3, "min_samples": 2},
    "hyperband": {"max_t": 27, "reduction_factor": 3},
    "curvefit": {"target_iteration": 27, "grace_period": 6, "margin": 0.05},
    "pbt": {"hyperparam_mutations": {"lr": [0.01, 0.1], "mom": None},
            "perturbation_interval": 3, "quantile_fraction": 0.34,
            "seed": 5},
}


def _decisions(pkg, name, mode):
    """Six trials of seeded saturating curves, interleaved iteration by
    iteration; a stopped trial reports no more. Returns every decision
    (and, for PBT, every exploit directive) in order."""
    import importlib
    exp = importlib.import_module(f"{pkg}.tune.experiment")
    sched = exp.SCHEDULERS[name](**SCHEDULERS[name])
    sched.set_mode("acc", mode)
    rng = np.random.default_rng(11)
    level = rng.uniform(0.2, 1.0, 6)
    rate = rng.uniform(0.05, 0.4, 6)
    noise = rng.normal(0.0, 0.01, (6, 28))
    tids = [f"t{i}" for i in range(6)]
    if name == "pbt":
        for i, tid in enumerate(tids):
            sched.register_config(tid, {"lr": 0.05 * (i + 1), "mom": 0.9})
    live = set(tids)
    log = []
    for it in range(1, 28):
        for i, tid in enumerate(tids):
            if tid not in live:
                continue
            acc = float(level[i] * (1 - math.exp(-rate[i] * it))
                        + noise[i, it])
            d = sched.on_result(tid, it, {"acc": acc})
            log.append((tid, it, d))
            if name == "pbt" and it % sched.interval == 0:
                log.append((tid, it, sched.exploit_directive(tid)))
            if d == "stop":
                live.discard(tid)
                sched.on_complete(tid)
    return log


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_decides_as_the_reference(name, mode):
    ours = _decisions("tosem_tpu_torch", name, mode)
    theirs = _decisions("tosem_tpu", name, mode)
    assert ours == theirs


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, check=True,
                          env={**os.environ, "PYTHONPATH": ROOT}).stdout


def test_hpo_plane_loads_neither_jax_nor_the_jax_package():
    out = _run("import sys, tosem_tpu_torch.tune as t, "
               "tosem_tpu_torch.analysis, tosem_tpu_torch.hpo_cli; "
               "[getattr(t, n) for n in t.__all__]; "
               "print(sorted(m for m in ('jax', 'tosem_tpu', 'torch') "
               "if m in sys.modules))")
    assert out.strip() == "[]"


def test_trial_worker_is_the_port_s_and_loads_no_numpy():
    """The node agent imports the worker's helpers, and the agent loads
    neither torch nor numpy."""
    out = _run("import sys; from tosem_tpu_torch.tune.trial_worker import "
               "worker_argv; "
               "print(worker_argv('m:f', '{}', 3, 'o', 'p')[1:3]); "
               "print(sorted(m for m in ('numpy', 'torch', 'jax', "
               "'tosem_tpu') if m in sys.modules))")
    argv, mods = out.strip().splitlines()
    assert argv == "['-m', 'tosem_tpu_torch.tune.trial_worker']"
    assert mods == "[]"
    from tosem_tpu.tune.trial_worker import worker_argv as ref_argv
    from tosem_tpu_torch.tune.trial_worker import worker_argv
    ours = worker_argv("m:f", "{}", 3, "o", "p", "c", 2)
    theirs = ref_argv("m:f", "{}", 3, "o", "p", "c", 2)
    assert ours[2] == "tosem_tpu_torch.tune.trial_worker"
    assert ours[3:] == theirs[3:]


def test_run_trial_streams_the_reference_s_metrics(tmp_path):
    from tosem_tpu.tune.providers import run_trial as ref_run_trial
    from tosem_tpu_torch.tune.providers import run_trial
    for target in ("quadratic", "counting"):
        got = run_trial(f"tosem_tpu_torch.tune.examples:{target}",
                        {"x": 0.5, "lr": 0.3}, 5,
                        checkpoint_path=str(tmp_path / f"p_{target}"),
                        checkpoint_freq=2)
        want = ref_run_trial(f"tosem_tpu.tune.examples:{target}",
                             {"x": 0.5, "lr": 0.3}, 5,
                             checkpoint_path=str(tmp_path / f"r_{target}"),
                             checkpoint_freq=2)
        for m in got["metrics"] + want["metrics"]:
            m.pop("pid", None)
        assert got == want


def _service_spec(pkg, tmp_path):
    spec = {"name": "svc", "trainable": f"{pkg}.tune.examples:quadratic",
            "space": {"x": {"type": "uniform", "low": -5, "high": 5}},
            "metric": "loss", "mode": "min", "num_samples": 2,
            "max_iterations": 3, "search_args": {"seed": 0},
            "training_service": "local"}
    path = tmp_path / f"{pkg}.json"
    path.write_text(json.dumps(spec))
    return str(path)


def test_results_after_a_service_run_fails_only_in_the_reference(
        tmp_path, capsys):
    """C-ref16: the JAX package's service rows lack ``iterations``, so
    its ``hpo_cli results`` raises ``KeyError``; the port's names the
    best trial, with the same scores."""
    from tosem_tpu.hpo_cli import main as ref_main
    from tosem_tpu_torch.hpo_cli import main
    outs = {}
    for pkg, fn in (("tosem_tpu", ref_main), ("tosem_tpu_torch", main)):
        db = str(tmp_path / f"{pkg}.db")
        assert fn(["create", "--spec", _service_spec(pkg, tmp_path),
                   "--db", db]) == 0
        assert fn(["run", "--name", "svc", "--db", db]) == 0
        capsys.readouterr()
        if pkg == "tosem_tpu":
            with pytest.raises(KeyError, match="iterations"):
                fn(["results", "--name", "svc", "--db", db])
        else:
            assert fn(["results", "--name", "svc", "--db", db]) == 0
        outs[pkg] = capsys.readouterr().out
    lines = outs["tosem_tpu_torch"].strip().splitlines()
    assert len(lines) == 2 and all("iters=   3" in ln for ln in lines)
