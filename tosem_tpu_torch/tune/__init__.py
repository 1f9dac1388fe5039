"""HPO layer — trial runner, schedulers, search algorithms (Tune/NNI-lite).

The port's copy of ``tosem_tpu/tune``, a re-design of the reference's
hyperparameter-optimization surface (SURVEY §2.1 Ray Tune, §2.4 NNI HPO):
trials are actors on the :mod:`tosem_tpu_torch.runtime`, processes of a
training service (``providers.py``) or subprocesses of node agents;
schedulers (ASHA, median stopping, PBT) and search algorithms (random,
grid, TPE-style, evolution) drive them; failed trials recover from
checkpoints (§5.3 elastic-recovery pattern, checkpoint-restart shaped).

Exports resolve lazily (PEP 562): a trial worker and a node agent import
``tune.trial_worker`` without loading numpy or the runtime.
"""

_LAZY_EXPORTS = {
    **{n: "tosem_tpu_torch.tune.schedulers" for n in (
        "ASHAScheduler", "CurveFittingAssessor", "FIFOScheduler",
        "HyperBandScheduler", "MedianStoppingRule", "PBTScheduler",
        "TrialScheduler")},
    **{n: "tosem_tpu_torch.tune.search" for n in (
        "BOHBSearch", "Choice", "Domain", "EvolutionSearch", "GPSearch",
        "GridSearch", "LogUniform", "PSOSearch", "RandInt", "RandomSearch",
        "SearchAlgorithm", "TPESearch", "Uniform", "choice", "grid_search",
        "loguniform", "randint", "uniform")},
    **{n: "tosem_tpu_torch.tune.experiment" for n in (
        "ExperimentManager", "space_from_json", "space_to_json")},
    **{n: "tosem_tpu_torch.tune.tune" for n in (
        "Analysis", "Trainable", "Trial", "run")},
    **{n: "tosem_tpu_torch.tune.providers" for n in (
        "LocalService", "NodeAgentService", "SubprocessService",
        "TrainingService", "run_with_service")},
}

__all__ = [
    "run", "Analysis", "Trainable", "Trial",
    "TrialScheduler", "FIFOScheduler", "ASHAScheduler", "MedianStoppingRule",
    "PBTScheduler", "HyperBandScheduler", "CurveFittingAssessor",
    "SearchAlgorithm", "RandomSearch", "GridSearch", "TPESearch",
    "EvolutionSearch", "GPSearch", "BOHBSearch", "PSOSearch",
    "uniform", "loguniform", "randint", "choice", "grid_search",
    "Domain", "Uniform", "LogUniform", "RandInt", "Choice",
    "ExperimentManager", "space_from_json", "space_to_json",
    "TrainingService", "LocalService", "SubprocessService",
    "NodeAgentService", "run_with_service",
]


def __getattr__(name: str):
    try:
        mod_name = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib
    value = getattr(importlib.import_module(mod_name), name)
    globals()[name] = value
    return value
