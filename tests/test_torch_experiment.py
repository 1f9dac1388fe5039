"""Experiment manager + hpo_cli tests (SURVEY §2.4 Experiment API/CLI,
NNI-manager and training-service rows).

A copy of ``tests/test_experiment.py`` against the port's
``tune/experiment.py`` and ``hpo_cli.py`` (its ``slow`` marks kept), and
the CLI's ``results`` after a training-service run, which the port's
rows carry ``iterations`` for."""
import json

import pytest

from tosem_tpu_torch.cluster.kv import KVStore
from tosem_tpu_torch.hpo_cli import main as hpo_main
from tosem_tpu_torch.tune.experiment import (ExperimentManager,
                                             space_from_json, space_to_json)
from tosem_tpu_torch.tune.search import Choice, LogUniform, RandInt, Uniform

SPEC = {
    "name": "quad",
    "trainable": "tosem_tpu_torch.tune.examples:quadratic",
    "space": {"x": {"type": "uniform", "low": -5, "high": 5},
              "lr": {"type": "loguniform", "low": 1e-2, "high": 1.0}},
    "metric": "loss",
    "mode": "min",
    "num_samples": 6,
    "max_iterations": 8,
    "scheduler": "asha",
    "search": "random",
}


def test_space_json_roundtrip():
    space = space_from_json({
        "a": {"type": "uniform", "low": 0, "high": 1},
        "b": {"type": "loguniform", "low": 0.1, "high": 10},
        "c": {"type": "randint", "low": 1, "high": 9},
        "d": {"type": "choice", "values": ["x", "y"]},
        "e": 42,
    })
    assert isinstance(space["a"], Uniform)
    assert isinstance(space["b"], LogUniform)
    assert isinstance(space["c"], RandInt)
    assert isinstance(space["d"], Choice)
    assert space["e"] == 42
    again = space_from_json(space_to_json(space))
    assert again["a"].low == 0.0 and again["c"].high == 9
    with pytest.raises(ValueError):
        space_from_json({"z": {"type": "mystery"}})


class TestManagerCRUD:
    def test_create_validates(self):
        mgr = ExperimentManager()
        with pytest.raises(ValueError):
            mgr.create({"name": "x"})                     # missing fields
        bad = dict(SPEC, scheduler="nope")
        with pytest.raises(ValueError):
            mgr.create(bad)
        mgr.create(dict(SPEC))
        with pytest.raises(ValueError):
            mgr.create(dict(SPEC))                        # duplicate name
        assert mgr.status("quad")["status"] == "created"
        assert [e["name"] for e in mgr.list()] == ["quad"]
        assert mgr.delete("quad") and not mgr.delete("quad")

    def test_state_shared_across_instances(self, tmp_path):
        path = str(tmp_path / "hpo.db")
        ExperimentManager(path=path).create(dict(SPEC))
        other = ExperimentManager(path=path)
        assert other.spec("quad")["metric"] == "loss"


@pytest.mark.slow
class TestRun:
    def test_run_records_results(self, tmp_path):
        mgr = ExperimentManager(path=str(tmp_path / "hpo.db"))
        mgr.create(dict(SPEC))
        state = mgr.run("quad")
        assert state["status"] == "done"
        assert state["n_trials"] == 6
        assert -5 <= state["best_config"]["x"] <= 5
        # raw metric (a loss): positive, and best ≤ every trial's best
        assert 0 < state["best_score"] < 50.0
        per_trial = [t["best_score"] for t in state["trials"]
                     if t["best_score"] is not None]
        assert state["best_score"] == pytest.approx(min(per_trial))
        # persisted: a fresh manager sees the finished run
        again = ExperimentManager(path=str(tmp_path / "hpo.db"))
        assert again.status("quad")["status"] == "done"
        assert len(again.results("quad")) == 6

    def test_cli_end_to_end(self, tmp_path, capsys):
        spec_path = tmp_path / "exp.json"
        spec_path.write_text(json.dumps(dict(SPEC, name="cli-exp",
                                             num_samples=4)))
        db = str(tmp_path / "cli.db")
        assert hpo_main(["create", "--spec", str(spec_path),
                         "--db", db]) == 0
        assert hpo_main(["run", "--name", "cli-exp", "--db", db]) == 0
        assert hpo_main(["status", "--name", "cli-exp", "--db", db]) == 0
        out = capsys.readouterr().out
        assert '"status": "done"' in out
        assert hpo_main(["results", "--name", "cli-exp", "--db", db,
                         "--top", "2"]) == 0
        assert len(capsys.readouterr().out.strip().splitlines()) == 2
        assert hpo_main(["list", "--db", db]) == 0
        assert "cli-exp" in capsys.readouterr().out
        assert hpo_main(["delete", "--name", "cli-exp", "--db", db]) == 0

    def test_failed_run_marks_state(self, tmp_path):
        mgr = ExperimentManager(path=str(tmp_path / "f.db"))
        spec = dict(SPEC, name="bad",
                    trainable="tosem_tpu_torch.tune.examples:does_not_exist")
        mgr.create(spec)
        with pytest.raises(AttributeError):
            mgr.run("bad")
        assert mgr.status("bad")["status"] == "failed"
        # lock released: a retry is allowed (and fails the same way)
        with pytest.raises(AttributeError):
            mgr.run("bad")

    def test_all_trials_erroring_marks_failed(self, tmp_path):
        mgr = ExperimentManager(path=str(tmp_path / "e.db"))
        spec = dict(SPEC, name="allerr", num_samples=2,
                    trainable="tosem_tpu_torch.tune.examples:always_crashes")
        mgr.create(spec)
        with pytest.raises(RuntimeError):
            mgr.run("allerr")
        assert mgr.status("allerr")["status"] == "failed"

    def test_concurrent_run_guard(self, tmp_path):
        import json as _json
        import os
        mgr = ExperimentManager(path=str(tmp_path / "g.db"))
        mgr.create(dict(SPEC, name="locked"))
        # a LIVE holder (this process) blocks a second run
        from tosem_tpu_torch.tune.experiment import _NS_LOCK
        live = _json.dumps({"pid": os.getpid(), "t": 0}).encode()
        assert mgr.kv.cas(_NS_LOCK, "locked", None, live)
        with pytest.raises(RuntimeError, match="already running"):
            mgr.run("locked")
        mgr.kv.delete(_NS_LOCK, "locked")

    def test_dead_holder_lock_reclaimed(self, tmp_path):
        import json as _json
        mgr = ExperimentManager(path=str(tmp_path / "d.db"))
        mgr.create(dict(SPEC, name="crashed", num_samples=2,
                        max_iterations=3))
        from tosem_tpu_torch.tune.experiment import _NS_LOCK
        # a lock whose holder pid no longer exists must be taken over
        dead = _json.dumps({"pid": 2 ** 22 + 12345, "t": 0}).encode()
        assert mgr.kv.cas(_NS_LOCK, "crashed", None, dead)
        state = mgr.run("crashed")          # reclaims, runs to completion
        assert state["status"] == "done"

    def test_force_takes_over_live_lock(self, tmp_path):
        import json as _json
        import os
        mgr = ExperimentManager(path=str(tmp_path / "f2.db"))
        mgr.create(dict(SPEC, name="forced", num_samples=2,
                        max_iterations=3))
        from tosem_tpu_torch.tune.experiment import _NS_LOCK
        live = _json.dumps({"pid": os.getpid(), "t": 0}).encode()
        assert mgr.kv.cas(_NS_LOCK, "forced", None, live)
        state = mgr.run("forced", force=True)
        assert state["status"] == "done"

    def test_unreadable_lock_requires_force(self, tmp_path):
        # a pre-upgrade b"running" lock may belong to a LIVE process:
        # never hijack it silently
        mgr = ExperimentManager(path=str(tmp_path / "u.db"))
        mgr.create(dict(SPEC, name="legacy", num_samples=2,
                        max_iterations=3))
        from tosem_tpu_torch.tune.experiment import _NS_LOCK
        assert mgr.kv.cas(_NS_LOCK, "legacy", None, b"running")
        with pytest.raises(RuntimeError, match="already running"):
            mgr.run("legacy")
        state = mgr.run("legacy", force=True)
        assert state["status"] == "done"

    def test_displaced_runner_does_not_release_successor_lock(
            self, tmp_path):
        mgr = ExperimentManager(path=str(tmp_path / "dl.db"))
        mgr.create(dict(SPEC, name="dl"))
        from tosem_tpu_torch.tune.experiment import _NS_LOCK
        mine = mgr._try_lock("dl", force=False)
        assert mine is not None
        # a forcing runner displaces us
        theirs = mgr._try_lock("dl", force=True)
        assert theirs is not None and theirs != mine
        # our conditional release must be a no-op on THEIR lock
        assert not mgr.kv.delete_if(_NS_LOCK, "dl", mine)
        assert mgr.kv.get(_NS_LOCK, "dl") == theirs
        assert mgr.kv.delete_if(_NS_LOCK, "dl", theirs)


def test_cli_results_after_a_service_run(tmp_path, capsys):
    """``results`` reads ``iterations`` of every row: after a
    training-service run too (the JAX package's rows lack it there)."""
    spec_path = tmp_path / "svc.json"
    spec_path.write_text(json.dumps(dict(
        SPEC, name="svc", num_samples=3, max_iterations=4,
        scheduler="fifo", search_args={"seed": 0},
        training_service="local", max_concurrent=2)))
    db = str(tmp_path / "svc.db")
    assert hpo_main(["create", "--spec", str(spec_path), "--db", db]) == 0
    assert hpo_main(["run", "--name", "svc", "--db", db]) == 0
    capsys.readouterr()
    assert hpo_main(["results", "--name", "svc", "--db", db,
                     "--top", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = ExperimentManager(path=db).results("svc")
    best = min(rows, key=lambda r: r["best_score"])
    assert len(lines) == 1 and lines[0].startswith(best["trial_id"])
    assert all(r["iterations"] == 4 and r["status"] == "SUCCEEDED"
               for r in rows)
