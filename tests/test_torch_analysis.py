"""The study's analysis layer (L8) in the port, held to the JAX package's.

A copy of ``tests/test_analysis.py`` against
:mod:`tosem_tpu_torch.analysis`, then across packages: ``run_study`` of
both packages writes every table file byte for byte alike, on the
reference test's sample suite and on this repo's ``tests/`` with the same
bench CSVs (the port's copy keeps the JAX package's ``tosem_tpu`` key for
the "repo" axis, and ``test_torch_*.py`` files import both packages).
Last, the port's CLI runs ``--config=analysis`` on the CPU. The
replication leg's agreement test needs the study checkout, named by
``TOSEM_STUDY_CHECKOUT``; without it the test skips, as the reference's
does without its mount.
"""
import csv
import os
import subprocess
import sys
import textwrap

import pytest

from tosem_tpu_torch.analysis import (
    bench_correlate, bench_summary, classify_tests, run_study,
)
from tosem_tpu_torch.analysis.study import METHODS, PROPERTIES, RQ4_HEADER

REPO_TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(REPO_TESTS)
TABLES = ("tests_methods.csv", "tests_correlate.csv", "tests_strategy.csv",
          "properties.csv", "bench_summary.csv", "bench_correlate.csv")


def _write_sample_suite(tmp_path):
    tmp_path.mkdir(parents=True, exist_ok=True)
    (tmp_path / "test_sample.py").write_text(textwrap.dedent('''
        import pytest
        import numpy as np
        from tosem_tpu.ops.gemm import gemm

        def test_matches_reference():
            np.testing.assert_allclose([1.0], [1.0], atol=1e-6)

        def test_rejects_bad_shape():
            with pytest.raises(ValueError):
                raise ValueError()

        def test_regression_overflow():
            """Regression: large inputs must not overflow."""
            assert abs(2.0 - 2.0) < 1e-9

        def test_end_to_end_pipeline():
            assert 1 == 1
    '''))
    return str(tmp_path)


def _bench_csv(tmp_path):
    path = tmp_path / "bench.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["timestamp", "project", "config", "bench_id",
                    "metric", "value", "unit", "device", "n_devices",
                    "extra"])
        # value perfectly tracks mfu, anti-tracks time_us
        for i, v in enumerate([100.0, 200.0, 300.0, 400.0]):
            w.writerow([0, "ops", "gemm", f"g{i}", "gflops", v,
                        "GFLOPS", "tpu", 1,
                        '{"mfu": %f, "time_us": %f}' % (v / 1000,
                                                        1e6 / v)])
    return str(path)


def _repo_results():
    return [os.path.join(ROOT, "results", n)
            for n in ("tpu_full.csv", "smoke.csv")]


@pytest.fixture(scope="module")
def repo_tables(tmp_path_factory):
    """``run_study`` of both packages over this repo's ``tests/`` with the
    same bench CSVs: (port summary, port dir, reference summary, its
    dir)."""
    from tosem_tpu.analysis import run_study as ref_run_study
    base = tmp_path_factory.mktemp("repo_tables")
    results = _repo_results() + [_bench_csv(base)]
    port = run_study(REPO_TESTS, results, str(base / "port"))
    ref = ref_run_study(REPO_TESTS, results, str(base / "ref"))
    return port, base / "port", ref, base / "ref"


class TestClassification:
    def test_sample_suite_taxonomy(self, tmp_path):
        cases = classify_tests(_write_sample_suite(tmp_path))
        by_name = {c.name: c for c in cases}
        assert len(cases) == 4
        assert by_name["test_matches_reference"].method == "unit_test"
        assert "absolute_relative_tolerence" in \
            by_name["test_matches_reference"].strategies
        assert "pseaudo_oracle" in by_name["test_matches_reference"].strategies
        assert "negative_test" in by_name["test_rejects_bad_shape"].strategies
        assert "value_error" in by_name["test_rejects_bad_shape"].strategies
        assert by_name["test_regression_overflow"].method == "regression"
        assert "error_bounding" in \
            by_name["test_regression_overflow"].strategies
        assert by_name["test_end_to_end_pipeline"].method == "end_to_end"
        assert all(c.project == "ops" for c in cases)
        assert all("Correctness" in c.properties for c in cases)

    def test_real_suite_classifies(self):
        """The analyzer must digest this very repo's suite: hundreds of
        tests, mostly unit, nearly all carrying at least one strategy."""
        cases = classify_tests(REPO_TESTS)
        assert len(cases) > 300
        methods = {c.method for c in cases}
        assert "unit_test" in methods and "integration" in methods
        with_strategy = sum(1 for c in cases if c.strategies)
        assert with_strategy / len(cases) > 0.9
        assert len({c.project for c in cases}) >= 10


class TestSchemas:
    def test_rq4_and_rq3_headers(self, tmp_path):
        out = tmp_path / "analysis"
        summary = run_study(_write_sample_suite(tmp_path / "suite"),
                            [], str(out))
        assert summary["n_tests"] == 4
        with open(out / "tests_methods.csv", newline="") as f:
            rows = list(csv.reader(f))
        # exact RQ4 schema (tests_methods_v3.csv)
        assert rows[0] == RQ4_HEADER
        assert [r[0] for r in rows[1:]] == METHODS
        total = sum(int(r[1]) for r in rows[1:])
        assert total == 4
        pct = sum(float(r[2]) for r in rows[1:])
        assert abs(pct - 100.0) < 0.1
        with open(out / "tests_correlate.csv", newline="") as f:
            rows = list(csv.reader(f))
        # exact RQ3 column set (tests_correlate_rq3.csv)
        assert rows[0] == ["Tests"] + PROPERTIES
        # cells are 0 or "project:(pct%), " lists
        for row in rows[1:]:
            for cell in row[1:]:
                assert cell == "0" or "%)" in cell

    def test_strategy_and_properties_tables(self, tmp_path):
        out = tmp_path / "analysis"
        run_study(_write_sample_suite(tmp_path / "suite"), [], str(out))
        with open(out / "tests_strategy.csv", newline="") as f:
            rows = list(csv.reader(f))
        assert rows[0][0] == "Tests" and rows[0][-1] == "MEAN"
        with open(out / "properties.csv", newline="") as f:
            rows = list(csv.reader(f))
        assert rows[0][0] == "Repos"
        assert any(r[0] == "Correctness" for r in rows[1:])


class TestBenchIngestion:
    def test_bench_summary(self, tmp_path):
        header, rows = bench_summary([_bench_csv(tmp_path)])
        assert header[:3] == ["config", "unit", "n_rows"]
        assert rows[0][0] == "gemm" and rows[0][2] == "4"
        assert float(rows[0][5]) == 400.0  # max
        assert rows[0][6] == "g3"          # best row id

    def test_bench_correlate_signs(self, tmp_path):
        header, rows = bench_correlate([_bench_csv(tmp_path)])
        assert header == ["config", "metric", "field", "n", "pearson",
                          "spearman"]
        by_field = {r[2]: r for r in rows}
        assert float(by_field["mfu"][4]) > 0.999     # perfect +corr
        assert float(by_field["mfu"][5]) > 0.999
        assert float(by_field["time_us"][5]) < -0.999  # rank anti-corr

    def test_missing_csv_is_empty_not_error(self):
        header, rows = bench_correlate(["/nonexistent/never.csv"])
        assert rows == []


class TestRepoAnalysisEndToEnd:
    def test_end_to_end_run_study_on_repo(self, repo_tables):
        """Full L8 loop: this repo's tests + its results CSVs in, RQ tables
        out — the analog of running the study's R scripts."""
        summary, out, _, _ = repo_tables
        assert summary["n_tests"] > 300
        assert summary["with_strategy_pct"] > 90
        for name in TABLES:
            assert (out / name).exists(), name


class TestReferenceReplication:
    """The replication leg: classifier over external subject trees
    (``analysis/replicate.py``), pinned on a vendored synthetic suite and
    — when the study checkout is present — scored against the published
    ``RQs/RQ3/tests_strategy_rq3.csv`` numbers."""

    def _write_subject(self, tmp_path):
        root = tmp_path / "subject"
        (root / "tests" / "unit").mkdir(parents=True)
        (root / "tests" / "integration").mkdir(parents=True)
        (root / "tests" / "unit" / "core_test.py").write_text(textwrap.dedent('''
            import unittest

            class CoreTest(unittest.TestCase):
                def test_equalities(self):
                    self.assertEqual(1, 1)
                    self.assertAlmostEqual(0.1 + 0.2, 0.3, places=6)

                def test_membership_and_types(self):
                    self.assertIn("a", ["a", "b"])
                    self.assertIsInstance([], list)
                    self.assertIsNotNone(object())

                def test_bad_input(self):
                    self.assertRaises(ValueError, int, "nope")

                def test_status_flag(self):
                    ok = True
                    self.assertTrue(ok)
        '''))
        (root / "tests" / "integration" / "pipe_tests.py").write_text(
            textwrap.dedent('''
            from nose.tools import assert_raises, assert_in

            def test_pipeline_rejects():
                assert_raises(TypeError, len, 3)
                assert_in(1, [1, 2])
        '''))
        (root / "tests" / "unit" / "helpers.py").write_text(
            "def test_not_a_test_file(): pass\n")
        return str(root)

    def test_classify_tree_vendored_suite(self, tmp_path):
        from tosem_tpu_torch.analysis.study import classify_tree
        cases = classify_tree(self._write_subject(tmp_path), project="subj")
        assert len(cases) == 5
        assert {c.project for c in cases} == {"subj"}
        by_name = {c.name: c for c in cases}
        # path-derived method: integration dir wins over unit default
        assert by_name["test_pipeline_rejects"].method == "integration"
        assert by_name["test_equalities"].method == "unit_test"
        # unittest + nose idioms land in the study's strategy vocabulary
        assert "basic_comparizon" in by_name["test_equalities"].strategies
        assert "rounding_tolence" in by_name["test_equalities"].strategies
        assert "sub_set_checks" in by_name["test_membership_and_types"].strategies
        assert "instance_check" in by_name["test_membership_and_types"].strategies
        assert "Null_pointer" in by_name["test_membership_and_types"].strategies
        assert "negative_test" in by_name["test_bad_input"].strategies
        assert "value_error" in by_name["test_bad_input"].strategies
        assert "status_analysis" in by_name["test_status_flag"].strategies
        assert "type_error" in by_name["test_pipeline_rejects"].strategies

    def test_classify_tree_equals_the_reference(self, tmp_path):
        from tosem_tpu.analysis.study import classify_tree as ref_tree
        from tosem_tpu_torch.analysis.study import classify_tree
        root = self._write_subject(tmp_path)
        ours = [vars(c) for c in classify_tree(root, project="subj")]
        theirs = [vars(c) for c in ref_tree(root, project="subj")]
        assert ours == theirs

    def test_reference_agreement(self, tmp_path):
        """Against the study checkout: our automatic per-repo strategy
        distribution must rank-correlate with the hand-labeled one."""
        from tosem_tpu_torch.analysis.replicate import run_replication
        study = os.environ.get("TOSEM_STUDY_CHECKOUT", "")
        if not (study and os.path.isdir(
                os.path.join(study, "src", "tpot", "v0.11.7"))):
            pytest.skip("study checkout not present (TOSEM_STUDY_CHECKOUT)")
        summary = run_replication(study, str(tmp_path / "out"),
                                  subjects=["tpot", "auto-sklearn"])
        agree = {r["project"]: r for r in summary["strategy_agreement"]}
        assert agree["tpot"]["spearman"] > 0.5
        assert agree["auto-sklearn"]["spearman"] > 0.5
        assert agree["auto-sklearn"]["top_overlap"] >= 3
        assert (tmp_path / "out" / "reference_strategy.csv").exists()
        assert (tmp_path / "out" / "reference_agreement.json").exists()


# -------------------------------------------------------- across packages

def _tables(out_dir):
    return {n: open(os.path.join(out_dir, n), "rb").read() for n in TABLES}


def test_sample_suite_tables_equal_the_reference_byte_for_byte(tmp_path):
    from tosem_tpu.analysis import run_study as ref_run_study
    suite = _write_sample_suite(tmp_path / "suite")
    results = [_bench_csv(tmp_path)]
    port = run_study(suite, results, str(tmp_path / "port"))
    ref = ref_run_study(suite, results, str(tmp_path / "ref"))
    assert {k: v for k, v in port.items() if k != "out_dir"} == \
        {k: v for k, v in ref.items() if k != "out_dir"}
    assert _tables(tmp_path / "port") == _tables(tmp_path / "ref")


def test_repo_suite_tables_equal_the_reference_byte_for_byte(repo_tables):
    """This repo's ``tests/``, the port's files included: the same
    attribution to ``tosem_tpu`` subpackages, so the same tables."""
    port, port_dir, ref, ref_dir = repo_tables
    assert {k: v for k, v in port.items() if k != "out_dir"} == \
        {k: v for k, v in ref.items() if k != "out_dir"}
    assert port["bench_correlations"] > 0
    assert _tables(port_dir) == _tables(ref_dir)


def test_project_key_is_the_jax_package_s(tmp_path):
    """A test file importing only the port attributes to no subpackage
    ("misc"), as in the reference; one importing ``tosem_tpu.tune``
    attributes to ``tune`` in both packages."""
    from tosem_tpu.analysis.study import classify_tests as ref_classify
    (tmp_path / "test_a.py").write_text(
        "from tosem_tpu_torch.tune import run\n\n"
        "def test_x():\n    assert run\n")
    (tmp_path / "test_b.py").write_text(
        "from tosem_tpu.tune import run\n"
        "from tosem_tpu_torch.tune import run as prun\n\n"
        "def test_y():\n    assert run is not prun\n")
    ours = {c.name: c.project for c in classify_tests(str(tmp_path))}
    theirs = {c.name: c.project for c in ref_classify(str(tmp_path))}
    assert ours == theirs == {"test_x": "misc", "test_y": "tune"}


# ------------------------------------------------------------------- CLI

def _cli(*args):
    return subprocess.run([sys.executable, "-m", "tosem_tpu_torch.cli",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": ROOT})


def test_cli_analysis_config_on_cpu(tmp_path, monkeypatch, capsys):
    """``--config=analysis``: its rows add up, ``bench_correlations`` is
    reported, a second run writes the same tables byte for byte (its own
    rows are never re-ingested), and the replication leg says it was
    skipped."""
    from tosem_tpu_torch.utils.results import read_results
    suite = _write_sample_suite(tmp_path / "suite")
    res = tmp_path / "res"
    res.mkdir()
    _bench_csv(res)
    csv_path = str(res / "analysis.csv")
    argv = ["--device=cpu", "--config=analysis", f"--tests_dir={suite}",
            f"--results_csv={csv_path}"]
    out = _cli(*argv, f"--analysis_out={tmp_path / 'out0'}")
    assert out.returncode == 0, out.stderr
    assert "replication leg skipped" in out.stdout
    # the second run in this process, from the same working directory
    from tosem_tpu_torch import cli
    monkeypatch.chdir(ROOT)
    assert cli.main([*argv, f"--analysis_out={tmp_path / 'out1'}"]) == 0
    assert "replication leg skipped" in capsys.readouterr().out
    assert _tables(tmp_path / "out0") == _tables(tmp_path / "out1")
    rows = [r for r in read_results(csv_path) if r["config"] == "analysis"]
    first, last = rows[:len(rows) // 2], rows[len(rows) // 2:]
    assert [r["bench_id"] for r in first] == [r["bench_id"] for r in last]
    by_id = {r["bench_id"]: r for r in last}
    strat = by_id["tests_with_strategy"]
    n = strat["extra"]["n_tests"]
    assert n == 4
    assert sum(r["value"] for r in last
               if r["bench_id"] != "tests_with_strategy") == n
    assert 0 <= strat["value"] <= 100
    assert strat["extra"]["bench_correlations"] > 0
    assert {r["device"] for r in last} == {"host"}


def test_cli_analysis_defaults_leave_the_reference_tables_alone():
    """Run with no output flag, the port's analysis writes its tables to
    its own folder: ``results/analysis`` holds the JAX package's
    committed tables, and the replication leg needs a named checkout."""
    from tosem_tpu_torch import cli
    args = cli.make_parser().parse_args(["--config=analysis"])
    assert os.path.normpath(args.analysis_out) == os.path.join(
        "results", "torch_analysis")
    assert args.reference_dir == ""
    assert args.tests_dir == "tests"
