"""Study analysis layer (SURVEY §1 L8) — the RQ3/RQ4 consumer.

Half the reference repo IS the TOSEM study: it classifies the subject
systems' tests by *method* (unit/regression/integration/end-to-end), by
*strategy* (the assertion taxonomy: rounding tolerance, instance checks,
negative tests, …) and by *quality property* (correctness, robustness,
efficiency, …), then correlates strategies with properties per project
(``RQs/RQ3/tests_correlate_rq3.csv``, ``RQs/RQ3/tests_strategy_rq3.csv``,
``RQs/RQ3/properties_rq3.csv``) and summarizes methods
(``RQs/RQ4/tests_methods_v3.csv``).

This module closes that loop by applying the same methodology to *this*
repo as the subject system:

- :func:`classify_tests` AST-walks ``tests/`` and tags every test function
  with method / strategies / properties / project (the ``tosem_tpu``
  subpackage it exercises — the "repo" axis of the study).
- :func:`methods_table` emits the RQ4 schema verbatim
  (``Test_methods,total_cases,percentage,correlate,Strategy,Repos``).
- :func:`correlate_table` emits the RQ3 strategy×property matrix with the
  reference's exact column set and ``project:(pct%)`` cell format.
- :func:`bench_summary` / :func:`bench_correlate` ingest ``results/*.csv``
  (the :mod:`tosem_tpu_torch.utils.results` schema) and produce per-config
  summaries plus Pearson/Spearman correlations between co-measured numeric
  fields — the numeric leg the reference draws as ``RQs/RQ3/Rplot01.pdf``.

Everything is stdlib + numpy; matplotlib is optional (plots skipped
without it).

The port's copy of ``tosem_tpu/analysis/study.py``. The "repo" axis
keeps the JAX package's name as its key: a test file is attributed to
the ``tosem_tpu`` subpackage it imports, so both packages' copies give
the same tables on the same tree (the port's ``test_torch_*.py`` files
import both packages).
"""
from __future__ import annotations

import ast
import csv
import json
import os
import re
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# taxonomy (names kept verbatim from the reference CSVs, misspellings and
# all, so the study's downstream R scripts keep working on our output)
# ---------------------------------------------------------------------------

# column set of RQs/RQ3/tests_correlate_rq3.csv, in order
PROPERTIES = [
    "Distribution", "Validity", "Consistency", "Completeness", "Correctness",
    "Robustness", "Efficiency", "Relation", "Scalability",
    "Feature Importance", "Restoration", "Concurrency", "uncertainty",
    "Anomaly", "Data Loss", "Bias", "Security", "Uniqueness", "Timeliness",
    "integration", "Compatibility",
]

METHODS = ["unit_test", "regression", "integration", "end_to_end"]

# exception name → strategy row name (RQ3/RQ4 strategy vocabulary)
_RAISES_STRATEGY = {
    "TypeError": "type_error",
    "ValueError": "value_error",
    "RuntimeError": "runtime_error",
    "KeyError": "key_error",
    "ImportError": "import_error",
    "MemoryError": "memory_error",
    "FileNotFoundError": "FileError",
    "FileExistsError": "FileError",
    "OSError": "FileError",
    "IOError": "FileError",
    "AssertionError": "AssertionError",
    "NotImplementedError": "NotImplementedError",
    "TimeoutError": "runtime_error",
}

# keyword → property, matched over file name + test name + docstring +
# source text (first match set wins per keyword; a test can carry several
# properties, like the reference's multi-label counting)
_PROPERTY_KEYWORDS = {
    "Efficiency": ("gflops", "gb/s", "throughput", "latency", "perf",
                   "bench", "img/s", "images_per_sec", "time_us", "speed"),
    "Scalability": ("mesh", "shard", "n_devices", "pjit", "multichip",
                    "pipeline", "allreduce", "all_gather", "psum", "spmd",
                    "world_size", "autoscal"),
    "Concurrency": ("thread", "lock", "race", "concurren", "barrier",
                    "steal", "inflight", "deadlock"),
    "Robustness": ("crash", "kill", "failure", "recover", "restart",
                   "fault", "elastic", "heartbeat", "retry", "replay"),
    "Restoration": ("checkpoint", "resume", "restore", "snapshot"),
    "Consistency": ("roundtrip", "serial", "determinis", "seed", "replay",
                    "idempotent", "stable"),
    "Validity": ("raises", "invalid", "reject", "refuse", "must divide",
                 "malformed"),
    "Completeness": ("schema", "coverage", "all_fields", "inventory"),
    "Timeliness": ("deadline", "timer", "timeout", "heartbeat"),
    "Anomaly": ("anomaly", "nab", "outlier"),
    "uncertainty": ("stochastic", "random_search", "sample", "monte"),
    "Security": ("auth", "secret", "loopback", "rce"),
    "integration": ("subprocess", "localcluster", "http", "end_to_end",
                    "server", "client"),
    "Data Loss": ("drop", "lost", "drain", "flush"),
    "Distribution": ("histogram", "distribution", "quantile"),
}


@dataclass
class TestCase:
    name: str
    file: str
    project: str                      # tosem_tpu subpackage under test
    method: str                       # unit_test | regression | …
    strategies: List[str] = field(default_factory=list)
    properties: List[str] = field(default_factory=list)


# ---------------------------------------------------------------------------
# AST classification
# ---------------------------------------------------------------------------

_SUBPACKAGES = ("ops", "nn", "models", "parallel", "runtime", "cluster",
                "tune", "serve", "rl", "train", "data", "automl", "nas",
                "compress", "dataflow", "obs", "profiler", "utils",
                "compile", "native", "analysis")


def _file_project(tree: ast.AST, source: str) -> str:
    """Dominant ``tosem_tpu`` subpackage imported by the test file."""
    counts: Counter = Counter()
    for node in ast.walk(tree):
        mods: List[str] = []
        if isinstance(node, ast.ImportFrom) and node.module:
            mods.append(node.module)
        elif isinstance(node, ast.Import):
            mods.extend(a.name for a in node.names)
        for m in mods:
            parts = m.split(".")
            if parts[0] == "tosem_tpu" and len(parts) > 1 \
                    and parts[1] in _SUBPACKAGES:
                # weight by how often the subpackage name appears in the
                # body (module-boundary match: "tosem_tpu.data" must not
                # swallow "tosem_tpu.dataflow" hits), so files importing
                # many subpackages attribute to the one they exercise
                pat = re.compile(rf"tosem_tpu\.{parts[1]}(?![A-Za-z0-9_])")
                counts[parts[1]] += 1 + len(pat.findall(source))
    return counts.most_common(1)[0][0] if counts else "misc"


def _assert_strategies(node: ast.Assert) -> List[str]:
    out: List[str] = []
    t = node.test
    if isinstance(t, ast.BoolOp):
        out.append("logical_condition")
        tests: List[ast.expr] = list(t.values)
    else:
        tests = [t]
    for tt in tests:
        if isinstance(tt, ast.Compare):
            for op, comp in zip(tt.ops, tt.comparators):
                if isinstance(op, ast.Eq) or isinstance(op, ast.NotEq):
                    out.append("basic_comparizon")
                elif isinstance(op, (ast.Lt, ast.Gt, ast.LtE, ast.GtE)):
                    # |a-b| < eps is error bounding; plain compares are
                    # value-range; compares against literal 0/1 are
                    # boundary checks
                    left = tt.left
                    if (isinstance(left, ast.Call)
                            and isinstance(left.func, ast.Name)
                            and left.func.id == "abs"):
                        out.append("error_bounding")
                    elif (isinstance(comp, ast.Constant)
                          and isinstance(comp.value, (int, float))
                          and comp.value in (0, 1)):
                        out.append("boundary")
                    else:
                        out.append("value_range")
                elif isinstance(op, (ast.Is, ast.IsNot)):
                    if isinstance(comp, ast.Constant) and comp.value is None:
                        out.append("Null_pointer")
                elif isinstance(op, (ast.In, ast.NotIn)):
                    out.append("sub_set_checks")
        if isinstance(tt, ast.Call):
            fn = tt.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else "")
            if name == "isinstance":
                out.append("instance_check")
            elif name in ("isfinite", "isnan", "all", "any"):
                out.append("status_analysis")
        elif isinstance(tt, (ast.Name, ast.Attribute)):
            # bare `assert flag` — truthiness of returned state
            out.append("status_analysis")
    return out


# unittest TestCase assert-method → strategy (the subject systems the
# study classifies — nupic, auto-sklearn, tpot, … — are unittest-heavy,
# so replicating their RQ3 rows needs this vocabulary, not just
# pytest/numpy idioms)
_UNITTEST_STRATEGY = {
    "assertEqual": "basic_comparizon",
    "assertNotEqual": "basic_comparizon",
    "assertCountEqual": "basic_comparizon",
    "assertSequenceEqual": "basic_comparizon",
    "assertListEqual": "basic_comparizon",
    "assertDictEqual": "basic_comparizon",
    "assertTupleEqual": "basic_comparizon",
    "assertSetEqual": "basic_comparizon",
    "assertItemsEqual": "basic_comparizon",      # py2 unittest (nupic)
    "assertAlmostEqual": "rounding_tolence",
    "assertNotAlmostEqual": "rounding_tolence",
    "assertAlmostEquals": "rounding_tolence",
    "assertGreater": "value_range",
    "assertGreaterEqual": "value_range",
    "assertLess": "value_range",
    "assertLessEqual": "value_range",
    "assertIn": "sub_set_checks",
    "assertNotIn": "sub_set_checks",
    "assertIsInstance": "instance_check",
    "assertNotIsInstance": "instance_check",
    "assertIsNone": "Null_pointer",
    "assertIsNotNone": "Null_pointer",
    "assertIs": "Null_pointer",
    "assertIsNot": "Null_pointer",
    "assertRegex": "status_analysis",
    "assertRegexpMatches": "status_analysis",
    # nose.tools snake_case variants (tpot's suite)
    "assert_not_equal": "basic_comparizon",
    "assert_in": "sub_set_checks",
    "assert_not_in": "sub_set_checks",
    "assert_greater": "value_range",
    "assert_greater_equal": "value_range",
    "assert_less": "value_range",
    "assert_less_equal": "value_range",
    "assert_is_instance": "instance_check",
    "assert_is_none": "Null_pointer",
    "assert_is_not_none": "Null_pointer",
}


def _call_strategies(node: ast.Call) -> List[str]:
    fn = node.func
    name = fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else "")
    out: List[str] = []
    if name in ("assert_allclose", "allclose", "approx", "isclose"):
        out.append("absolute_relative_tolerence")
    elif name in ("assert_almost_equal", "assert_approx_equal",
                  "assert_array_almost_equal"):
        out.append("rounding_tolence")
    elif name in ("assert_array_equal", "assert_equal"):
        out.append("basic_comparizon")
    elif name == "isinstance":
        out.append("instance_check")
    elif name in _UNITTEST_STRATEGY:
        out.append(_UNITTEST_STRATEGY[name])
    elif name in ("assertTrue", "assertFalse", "assert_",
                  "assert_true", "assert_false"):
        # the study's labelers split truthiness asserts: checking a
        # returned flag/state is "status analysis", a compound or
        # comparison expression is a "logical condition"
        arg = node.args[0] if node.args else None
        if isinstance(arg, (ast.Compare, ast.BoolOp, ast.BinOp)):
            out.append("logical_condition")
        else:
            out.append("status_analysis")
    if name in ("raises", "assertRaises", "assertRaisesRegex",
                "assertRaisesRegexp", "assertWarns", "assert_raises",
                "assert_raises_regex"):
        out.append("negative_test")
        for a in node.args:
            exc = a.id if isinstance(a, ast.Name) else (
                a.attr if isinstance(a, ast.Attribute) else "")
            if exc in _RAISES_STRATEGY:
                out.append(_RAISES_STRATEGY[exc])
    if any(kw.arg in ("atol", "rtol", "abs_tol", "rel_tol", "tol")
           for kw in node.keywords if kw.arg):
        out.append("absolute_relative_tolerence")
    return out


def _test_strategies(fn: ast.FunctionDef, src_seg: str) -> List[str]:
    out: List[str] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assert):
            out.extend(_assert_strategies(node))
        elif isinstance(node, ast.Call):
            out.extend(_call_strategies(node))
        elif isinstance(node, ast.Try):
            out.append("error_handling")
    doc = (ast.get_docstring(fn) or "").lower()
    name = fn.name.lower()
    if ("reference" in name or "matches" in name or "parity" in name
            or "golden" in name or "vs the xla" in doc
            or "reference" in doc.split(".")[0]):
        out.append("pseaudo_oracle")
    return sorted(set(out))


def _test_properties(fn: ast.FunctionDef, file_name: str,
                     src_seg: str) -> List[str]:
    text = " ".join((file_name.lower(), fn.name.lower(),
                     (ast.get_docstring(fn) or "").lower(),
                     src_seg.lower()))
    props = [p for p, kws in _PROPERTY_KEYWORDS.items()
             if any(k in text for k in kws)]
    # every test asserts *something* about behavior — Correctness is the
    # base property unless the test is purely a perf probe
    if set(props) != {"Efficiency"}:
        props.append("Correctness")
    return sorted(set(props))


def _test_method(fn: ast.FunctionDef, file_name: str, src_seg: str) -> str:
    doc = (ast.get_docstring(fn) or "").lower()
    name = fn.name.lower()
    low = src_seg.lower()
    if "regression" in name or doc.startswith("regression"):
        return "regression"
    if ("end_to_end" in name or "e2e" in name or "end-to-end" in doc
            or "cli.main" in src_seg or "run_experiments" in low):
        return "end_to_end"
    if ("subprocess" in low or "localcluster" in src_seg
            or "httpserver" in low or "http.client" in low
            or "urlopen" in low or "start_server" in low
            or "spawn" in low):
        return "integration"
    return "unit_test"


def _classify_file(path: str, rel_name: str,
                   project: Optional[str] = None) -> List[TestCase]:
    """AST-classify every ``test*`` function/method in one file.
    ``project=None`` derives it from ``tosem_tpu`` imports (self-study
    mode); a fixed name is used when walking an external subject tree."""
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (SyntaxError, OSError, ValueError):
        return []
    proj = project or _file_project(tree, source)
    # directory names carry the method signal in the subject systems
    # (nupic's tests/{unit,integration,swarming}/, DeepSpeech's
    # regression suites) — a path-level hint the per-test text may lack
    low_rel = rel_name.lower()
    path_method = None
    if "integration" in low_rel:
        path_method = "integration"
    elif "regression" in low_rel:
        path_method = "regression"
    elif "end_to_end" in low_rel or "e2e" in low_rel:
        path_method = "end_to_end"
    cases: List[TestCase] = []
    for node in ast.walk(tree):
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and (node.name.startswith("test")
                     or node.name.endswith("_test"))):
            seg = ast.get_source_segment(source, node) or ""
            method = _test_method(node, rel_name, seg)
            if method == "unit_test" and path_method:
                method = path_method
            cases.append(TestCase(
                name=node.name, file=rel_name, project=proj,
                method=method,
                strategies=_test_strategies(node, seg),
                properties=_test_properties(node, rel_name, seg)))
    return cases


def classify_tests(tests_dir: str) -> List[TestCase]:
    """AST-classify every ``test_*`` function under ``tests_dir``."""
    cases: List[TestCase] = []
    for fname in sorted(os.listdir(tests_dir)):
        if not (fname.startswith("test_") and fname.endswith(".py")):
            continue
        cases.extend(_classify_file(os.path.join(tests_dir, fname), fname))
    return cases


def is_test_file(fname: str) -> bool:
    """Test-file naming across the subject systems: pytest's
    ``test_*.py``, nupic/apollo's ``*_test.py``, tpot's ``*_tests.py``."""
    return fname.endswith(".py") and (
        fname.startswith("test_") or fname.endswith("_test.py")
        or fname.endswith("_tests.py"))


def classify_tree(root: str, project: str,
                  max_files: Optional[int] = None) -> List[TestCase]:
    """Recursively AST-classify an external subject system's tests —
    the leg that applies the study's methodology to the study's own
    subjects (reference ``RQs/`` inputs were hand-labeled from these
    same trees). Helper/fixture modules under ``unittesthelpers`` etc.
    are skipped like the study skips them."""
    cases: List[TestCase] = []
    n_files = 0
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames
            if d not in (".git", "node_modules", "build", "bazel-out",
                         "third_party", "__pycache__"))
        # filter on the path RELATIVE to the subject root — an ancestor
        # directory named e.g. "fixtures" must not skip the whole tree
        low_dir = os.path.relpath(dirpath, root).lower()
        if "helper" in low_dir or "fixture" in low_dir:
            continue
        for fname in sorted(filenames):
            if not is_test_file(fname) or "helper" in fname.lower():
                continue
            rel = os.path.relpath(os.path.join(dirpath, fname), root)
            cases.extend(_classify_file(
                os.path.join(dirpath, fname), rel, project=project))
            n_files += 1
            if max_files is not None and n_files >= max_files:
                return cases
    return cases


# ---------------------------------------------------------------------------
# RQ4: method table (schema of RQs/RQ4/tests_methods_v3.csv)
# ---------------------------------------------------------------------------

RQ4_HEADER = ["Test_methods", "total_cases", "percentage", "correlate",
              "Strategy", "Repos"]


def methods_table(cases: Sequence[TestCase]) -> List[List[str]]:
    total = len(cases) or 1
    rows: List[List[str]] = []
    for method in METHODS:
        sub = [c for c in cases if c.method == method]
        strategies: List[str] = []
        repos: List[str] = []
        for c in sub:
            strategies.extend(c.strategies)
            repos.append(c.project)
        strat_order = [s for s, _ in Counter(strategies).most_common()]
        repo_order = [r for r, _ in Counter(repos).most_common()]
        correlate = sum(1 for c in sub if c.strategies)
        rows.append([
            method, str(len(sub)), f"{100.0 * len(sub) / total:.4g}",
            str(correlate),
            "".join(f"{s}, " for s in strat_order),
            "".join(f"{r}, " for r in repo_order),
        ])
    return rows


# ---------------------------------------------------------------------------
# RQ3: strategy × property correlation matrix
# (schema of RQs/RQ3/tests_correlate_rq3.csv)
# ---------------------------------------------------------------------------

def correlate_table(cases: Sequence[TestCase]
                    ) -> Tuple[List[str], List[List[str]]]:
    header = ["Tests"] + PROPERTIES
    per_project_total = Counter(c.project for c in cases)
    projects = sorted(per_project_total)
    # count (strategy, property, project) co-occurrences
    co: Dict[Tuple[str, str], Counter] = defaultdict(Counter)
    strategies: List[str] = []
    for c in cases:
        for s in c.strategies:
            if s not in strategies:
                strategies.append(s)
            for p in c.properties:
                co[(s, p)][c.project] += 1
    rows: List[List[str]] = []
    for s in sorted(strategies):
        row = [s]
        for p in PROPERTIES:
            counts = co.get((s, p))
            if not counts:
                row.append("0")
                continue
            parts = []
            for proj in projects:
                if counts.get(proj):
                    pct = 100.0 * counts[proj] / per_project_total[proj]
                    parts.append(f"{proj}:({pct:.4g}%), ")
            row.append("".join(parts) or "0")
        rows.append(row)
    return header, rows


def strategy_table(cases: Sequence[TestCase]
                   ) -> Tuple[List[str], List[List[str]]]:
    """Strategy usage per project in % (RQs/RQ3/tests_strategy_rq3.csv)."""
    per_project_total = Counter(c.project for c in cases)
    projects = sorted(per_project_total)
    use: Dict[str, Counter] = defaultdict(Counter)
    for c in cases:
        for s in set(c.strategies):
            use[s][c.project] += 1
    header = ["Tests"] + projects + ["MEAN"]
    rows = []
    for s in sorted(use):
        pcts = [100.0 * use[s][p] / per_project_total[p] for p in projects]
        rows.append([s] + [f"{v:.4g}" for v in pcts]
                    + [f"{float(np.mean(pcts)):.4g}"])
    return header, rows


def properties_table(cases: Sequence[TestCase]
                     ) -> Tuple[List[str], List[List[str]]]:
    """Property coverage per project in % (RQs/RQ3/properties_rq3.csv)."""
    per_project_total = Counter(c.project for c in cases)
    projects = sorted(per_project_total)
    cov: Dict[str, Counter] = defaultdict(Counter)
    for c in cases:
        for p in set(c.properties):
            cov[p][c.project] += 1
    header = ["Repos"] + projects
    rows = []
    for prop in PROPERTIES:
        if prop not in cov:
            continue
        rows.append([prop] + [
            f"{100.0 * cov[prop][p] / per_project_total[p]:.4g}"
            for p in projects])
    return header, rows


# ---------------------------------------------------------------------------
# bench CSV ingestion (numeric RQ3 leg)
# ---------------------------------------------------------------------------

def _load_bench_rows(csv_paths: Iterable[str]) -> List[dict]:
    rows: List[dict] = []
    for path in csv_paths:
        if not os.path.exists(path):
            continue
        with open(path, newline="") as f:
            for r in csv.DictReader(f):
                if r.get("config") == "analysis":
                    continue  # never re-ingest our own output rows
                try:
                    r["value"] = float(r["value"])
                except (ValueError, KeyError):
                    continue
                try:
                    r["extra"] = json.loads(r.get("extra") or "{}")
                except json.JSONDecodeError:
                    r["extra"] = {}
                rows.append(r)
    return rows


def bench_summary(csv_paths: Iterable[str]
                  ) -> Tuple[List[str], List[List[str]]]:
    """Per-(config, unit) summary over results CSVs."""
    rows = _load_bench_rows(csv_paths)
    groups: Dict[Tuple[str, str], List[dict]] = defaultdict(list)
    for r in rows:
        groups[(r.get("config", "?"), r.get("unit", ""))].append(r)
    header = ["config", "unit", "n_rows", "mean", "min", "max", "best_row"]
    out = []
    for (cfg, unit), rs in sorted(groups.items()):
        vals = np.array([r["value"] for r in rs], dtype=np.float64)
        best = max(rs, key=lambda r: r["value"])
        out.append([cfg, unit, str(len(rs)), f"{vals.mean():.6g}",
                    f"{vals.min():.6g}", f"{vals.max():.6g}",
                    best.get("bench_id", "")])
    return header, out


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    if ra.std() == 0 or rb.std() == 0:
        return float("nan")
    return float(np.corrcoef(ra, rb)[0, 1])


def bench_correlate(csv_paths: Iterable[str], min_n: int = 3
                    ) -> Tuple[List[str], List[List[str]]]:
    """Pearson/Spearman between ``value`` and each numeric ``extra`` field,
    per (config, metric) family — e.g. how GFLOPS tracks MFU across the
    conv sweep, or how time_us anti-tracks throughput."""
    rows = _load_bench_rows(csv_paths)
    fams: Dict[Tuple[str, str], List[dict]] = defaultdict(list)
    for r in rows:
        fams[(r.get("config", "?"), r.get("metric", "?"))].append(r)
    header = ["config", "metric", "field", "n", "pearson", "spearman"]
    out: List[List[str]] = []
    for (cfg, metric), rs in sorted(fams.items()):
        numeric_fields = sorted({
            k for r in rs for k, v in r["extra"].items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)})
        for fld in numeric_fields:
            pairs = [(r["value"], float(r["extra"][fld])) for r in rs
                     if isinstance(r["extra"].get(fld), (int, float))]
            if len(pairs) < min_n:
                continue
            a = np.array([p[0] for p in pairs])
            b = np.array([p[1] for p in pairs])
            if a.std() == 0 or b.std() == 0:
                continue
            pear = float(np.corrcoef(a, b)[0, 1])
            out.append([cfg, metric, fld, str(len(pairs)),
                        f"{pear:.4f}", f"{_spearman(a, b):.4f}"])
    return header, out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _write_csv(path: str, header: Sequence[str],
               rows: Iterable[Sequence[str]]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _plot_strategies(cases: Sequence[TestCase], path: str) -> bool:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    counts = Counter(s for c in cases for s in c.strategies)
    if not counts:
        return False
    names, vals = zip(*counts.most_common())
    fig, axis = plt.subplots(figsize=(10, 4))
    axis.bar(range(len(names)), vals)
    axis.set_xticks(range(len(names)))
    axis.set_xticklabels(names, rotation=60, ha="right", fontsize=7)
    axis.set_ylabel("tests using strategy")
    axis.set_title("Test strategy usage (RQ3)")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return True


def run_study(tests_dir: str, results_glob: Sequence[str],
              out_dir: str) -> Dict[str, object]:
    """Run the full analysis; writes the RQ tables and returns a summary."""
    cases = classify_tests(tests_dir)
    _write_csv(os.path.join(out_dir, "tests_methods.csv"), RQ4_HEADER,
               methods_table(cases))
    h, rows = correlate_table(cases)
    _write_csv(os.path.join(out_dir, "tests_correlate.csv"), h, rows)
    h, rows = strategy_table(cases)
    _write_csv(os.path.join(out_dir, "tests_strategy.csv"), h, rows)
    h, rows = properties_table(cases)
    _write_csv(os.path.join(out_dir, "properties.csv"), h, rows)
    h, rows = bench_summary(results_glob)
    _write_csv(os.path.join(out_dir, "bench_summary.csv"), h, rows)
    h, corr_rows = bench_correlate(results_glob)
    _write_csv(os.path.join(out_dir, "bench_correlate.csv"), h, corr_rows)
    plotted = _plot_strategies(
        cases, os.path.join(out_dir, "strategies.pdf"))
    by_method = Counter(c.method for c in cases)
    return {
        "n_tests": len(cases),
        "by_method": dict(by_method),
        "n_projects": len({c.project for c in cases}),
        "n_strategies": len({s for c in cases for s in c.strategies}),
        "with_strategy_pct": round(
            100.0 * sum(1 for c in cases if c.strategies)
            / max(1, len(cases)), 2),
        "bench_correlations": len(corr_rows),
        "plotted": plotted,
        "out_dir": out_dir,
    }
