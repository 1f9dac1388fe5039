"""The study's analysis layer: the port's copy of ``tosem_tpu/analysis``
(stdlib and numpy only)."""
from tosem_tpu_torch.analysis.study import (
    TestCase, classify_tests, methods_table, correlate_table,
    strategy_table, properties_table, bench_summary, bench_correlate,
    run_study,
)

__all__ = [
    "TestCase", "classify_tests", "methods_table", "correlate_table",
    "strategy_table", "properties_table", "bench_summary",
    "bench_correlate", "run_study",
]
