"""Replication leg of the L8 study — run the classifier over the
reference's OWN subject systems and compare with the published tables.

:mod:`tosem_tpu_torch.analysis.study` replicates the TOSEM study's
*methodology* (AST test classification → RQ3/RQ4 tables) with this repo
as the subject. This module closes the remaining gap: the study's
published numbers (``RQs/RQ3/tests_strategy_rq3.csv``,
``RQs/RQ3/properties_rq3.csv``, ``RQs/RQ4/tests_methods_v3.csv``) were
hand-labeled from the nine subject systems vendored under the study
checkout's ``src/``; running our classifier over those same trees
and correlating per-repo strategy distributions against the published
ones turns "schema-compatible" into "replicates the study".

Outputs (under ``--out``):

- ``reference_<proj>_methods.csv`` — RQ4 schema per subject
- ``reference_strategy.csv`` — per-subject strategy % (RQ3 schema)
- ``reference_properties.csv`` — per-subject property coverage %
- ``reference_agreement.csv`` / ``reference_agreement.json`` —
  Spearman rank correlation + top-5 overlap between our automatic
  per-repo strategy distribution and the study's hand-labeled one,
  plus the method-mix comparison vs ``tests_methods_v3.csv``.

Pure-Python subjects by default (nupic, auto-sklearn, tpot, autokeras —
the trees whose tests are Python end-to-end); the classifier is
language-bound, matching the study's own Python-test scoping for RQ3.

The port's copy of ``tosem_tpu/analysis/replicate.py``. ``--reference``
names the study checkout; it has no default, and nothing is downloaded.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tosem_tpu_torch.analysis.study import (METHODS, RQ4_HEADER, TestCase,
                                            _spearman, _write_csv,
                                            classify_tree, methods_table,
                                            properties_table,
                                            strategy_table)

# our subject key → (tree under <reference>/src, column name used by the
# published CSVs). Versions pinned to the study's vendored snapshots.
SUBJECTS: Dict[str, Tuple[str, str]] = {
    "nupic": ("nupic/1.0.5", "Nupic"),
    "auto-sklearn": ("auto-sklearn/v0.12.0", "auto_sklearn"),
    "tpot": ("tpot/v0.11.7", "tpot"),
    "autokeras": ("autokeras", "autokeras"),
}


def _subject_root(reference: str, rel: str) -> Optional[str]:
    base = os.path.join(reference, "src", rel)
    if os.path.isdir(base):
        return base
    # version dir not pinned (e.g. autokeras/<ver>/): take the sole child
    parent = os.path.join(reference, "src", rel.split("/")[0])
    if os.path.isdir(parent):
        subs = sorted(d for d in os.listdir(parent)
                      if os.path.isdir(os.path.join(parent, d)))
        if len(subs) == 1:
            return os.path.join(parent, subs[0])
    return None


def load_published_strategy(path: str) -> Dict[str, Dict[str, float]]:
    """Parse ``tests_strategy_rq3.csv`` → {strategy: {repo: pct}}.
    The file repeats the repo columns (raw % block then a rounded
    block); the FIRST occurrence of each repo column wins."""
    out: Dict[str, Dict[str, float]] = {}
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = list(csv.reader(f))
    header = rows[0]
    first_col: Dict[str, int] = {}
    for i, name in enumerate(header[1:], start=1):
        if name and name not in first_col:
            first_col[name] = i
    for row in rows[1:]:
        if not row or not row[0]:
            continue
        vals: Dict[str, float] = {}
        for repo, i in first_col.items():
            if repo == "MEAN" or i >= len(row):
                continue
            try:
                vals[repo] = float(row[i])
            except ValueError:
                pass
        out[row[0]] = vals
    return out


def load_published_methods(path: str) -> Dict[str, float]:
    """Parse ``tests_methods_v3.csv`` → {method: pct of all tests}."""
    out: Dict[str, float] = {}
    with open(path, newline="", encoding="utf-8-sig") as f:
        for r in csv.DictReader(f):
            try:
                out[r["Test_methods"]] = float(r["percentage"])
            except (KeyError, ValueError):
                continue
    return out


def _our_strategy_pct(cases: Sequence[TestCase]
                      ) -> Dict[str, Dict[str, float]]:
    """{strategy: {project: pct of project's tests using it}} — the
    same statistic the published strategy table reports."""
    totals = Counter(c.project for c in cases)
    use: Dict[str, Counter] = {}
    for c in cases:
        for s in set(c.strategies):
            use.setdefault(s, Counter())[c.project] += 1
    return {s: {p: 100.0 * n / totals[p] for p, n in cnt.items()}
            for s, cnt in use.items()}


TOP_K = 5


def agreement(cases: Sequence[TestCase], published: Dict[str, Dict[str, float]],
              col_of: Dict[str, str], top_k: int = TOP_K) -> List[dict]:
    """Per-subject agreement between our automatic strategy distribution
    and the study's hand-labeled one, over the shared vocabulary."""
    ours = _our_strategy_pct(cases)
    shared = sorted(set(published) & set(ours))
    rows = []
    for proj, col in col_of.items():
        a = np.array([ours.get(s, {}).get(proj, 0.0) for s in shared])
        b = np.array([published[s].get(col, 0.0) for s in shared])
        if not len(shared) or a.std() == 0 or b.std() == 0:
            continue
        ours_top = [s for s in sorted(
            shared, key=lambda s: -ours.get(s, {}).get(proj, 0.0))][:top_k]
        pub_top = [s for s in sorted(
            shared, key=lambda s: -published[s].get(col, 0.0))][:top_k]
        rows.append({
            "project": proj,
            "published_column": col,
            "n_shared_strategies": len(shared),
            "spearman": round(_spearman(a, b), 4),
            "pearson": round(float(np.corrcoef(a, b)[0, 1]), 4),
            "top_k": top_k,
            "top_overlap": len(set(ours_top) & set(pub_top)),
            "ours_top": ours_top,
            "published_top": pub_top,
        })
    return rows


def run_replication(reference: str, out_dir: str,
                    subjects: Optional[Sequence[str]] = None,
                    max_files: Optional[int] = None) -> Dict[str, object]:
    """Classify the reference's subject systems and score agreement."""
    names = list(subjects or SUBJECTS)
    unknown = [n for n in names if n not in SUBJECTS]
    if unknown:
        raise ValueError(
            f"unknown subject(s) {unknown}; valid: {sorted(SUBJECTS)}")
    all_cases: List[TestCase] = []
    per_subject: Dict[str, int] = {}
    for name in names:
        rel, _col = SUBJECTS[name]
        root = _subject_root(reference, rel)
        if root is None:
            raise FileNotFoundError(
                f"subject tree for {name!r} not found under "
                f"{os.path.join(reference, 'src', rel)!r} — wrong "
                "--reference path or unmounted study checkout")
        cases = classify_tree(root, project=name, max_files=max_files)
        per_subject[name] = len(cases)
        all_cases.extend(cases)
        _write_csv(os.path.join(out_dir, f"reference_{name}_methods.csv"),
                   RQ4_HEADER, methods_table(cases))
    h, rows = strategy_table(all_cases)
    _write_csv(os.path.join(out_dir, "reference_strategy.csv"), h, rows)
    h, rows = properties_table(all_cases)
    _write_csv(os.path.join(out_dir, "reference_properties.csv"), h, rows)

    summary: Dict[str, object] = {
        "subjects": per_subject, "n_tests": len(all_cases)}
    pub_strat_path = os.path.join(
        reference, "RQs", "RQ3", "tests_strategy_rq3.csv")
    if os.path.exists(pub_strat_path):
        published = load_published_strategy(pub_strat_path)
        col_of = {n: SUBJECTS[n][1] for n in per_subject}
        agree = agreement(all_cases, published, col_of)
        _write_csv(
            os.path.join(out_dir, "reference_agreement.csv"),
            ["project", "published_column", "n_shared_strategies",
             "spearman", "pearson", f"top{TOP_K}_overlap"],
            [[r["project"], r["published_column"],
              str(r["n_shared_strategies"]), str(r["spearman"]),
              str(r["pearson"]), str(r["top_overlap"])] for r in agree])
        summary["strategy_agreement"] = agree

    pub_meth_path = os.path.join(
        reference, "RQs", "RQ4", "tests_methods_v3.csv")
    if os.path.exists(pub_meth_path):
        pub_methods = load_published_methods(pub_meth_path)
        ours = Counter(c.method for c in all_cases)
        total = max(1, len(all_cases))
        summary["methods"] = {
            m: {"ours_pct": round(100.0 * ours.get(m, 0) / total, 2),
                "published_pct": pub_methods.get(m)}
            for m in METHODS}

    with open(os.path.join(out_dir, "reference_agreement.json"), "w") as f:
        json.dump(summary, f, indent=1, sort_keys=True)
    return summary


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reference", required=True,
                    help="the study checkout (its src/ holds the subjects)")
    ap.add_argument("--out", default="results/analysis")
    ap.add_argument("--subjects", nargs="*", default=None,
                    choices=sorted(SUBJECTS))
    ap.add_argument("--max_files", type=int, default=None)
    args = ap.parse_args(argv)
    summary = run_replication(args.reference, args.out,
                              subjects=args.subjects,
                              max_files=args.max_files)
    print(json.dumps(summary, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
