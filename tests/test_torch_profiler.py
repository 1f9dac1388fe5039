"""The port's profiler (``tosem_tpu_torch/profiler/``): copies of
``tests/test_profiler.py`` over a ``torch.profiler`` capture on the CPU,
and the parser's device planes over a trace with kernel events. The
kernel summary keeps the JAX package's CSV columns."""
import csv
import json
import time

import pytest
import torch

from tosem_tpu_torch.profiler import (KERNEL_CSV_COLUMNS, SpanRecorder,
                                      capture_trace, chrome_trace_dump,
                                      get_recorder, kernel_summary,
                                      kernel_summary_csv, parse_trace, span)

torch.set_num_threads(1)


def test_csv_columns_are_the_reference_s():
    from tosem_tpu.profiler.trace import KERNEL_CSV_COLUMNS as REF
    assert KERNEL_CSV_COLUMNS == REF


class TestSpans:
    def test_span_records_duration(self):
        rec = SpanRecorder()
        with rec.span("work", cat="test", k=1):
            time.sleep(0.01)
        spans = rec.spans()
        assert len(spans) == 1
        assert spans[0].name == "work"
        assert spans[0].dur_us >= 10_000 * 0.5
        assert spans[0].args == {"k": 1}

    def test_chrome_trace_format(self, tmp_path):
        rec = SpanRecorder()
        with rec.span("a"):
            pass
        with rec.span("b"):
            pass
        path = rec.dump(str(tmp_path / "t.json"))
        evs = json.load(open(path))["traceEvents"]
        assert len(evs) == 2
        assert all(e["ph"] == "X" for e in evs)
        assert {e["name"] for e in evs} == {"a", "b"}
        assert all("ts" in e and "dur" in e for e in evs)

    def test_global_recorder(self, tmp_path):
        get_recorder().clear()
        with span("global_work"):
            pass
        path = chrome_trace_dump(str(tmp_path / "g.json"))
        names = [e["name"] for e in json.load(open(path))["traceEvents"]]
        assert "global_work" in names
        get_recorder().clear()


class TestTracePipeline:
    @pytest.fixture(scope="class")
    def capture_dir(self, tmp_path_factory):
        d = str(tmp_path_factory.mktemp("trace"))
        with capture_trace(d):
            x = torch.ones(256, 256)
            torch.matmul(x, x)
        return d

    def test_parse_and_summarize(self, capture_dir):
        stats = kernel_summary(capture_dir)
        assert stats, "expected events in the capture"
        assert sum(s.total_us for s in stats) > 0
        assert all(stats[i].total_us >= stats[i + 1].total_us
                   for i in range(len(stats) - 1))
        # a CPU capture falls back to the host's ops
        assert {s.plane for s in stats} == {"/host:CPU"}
        assert any("mm" in s.name for s in stats)

    def test_csv_schema(self, capture_dir, tmp_path):
        out = str(tmp_path / "kernels.csv")
        stats = kernel_summary_csv(capture_dir, out)
        rows = list(csv.DictReader(open(out)))
        assert len(rows) == len(stats)
        r = rows[0]
        for col in KERNEL_CSV_COLUMNS:
            assert col in r
        assert float(r["total_us"]) >= float(r["min_us"])
        pct = sum(float(x["pct"]) for x in rows)
        assert 99.0 < pct < 101.0


def _trace_with_kernels(path):
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "tid": 1,
         "ts": 0, "dur": 50.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 1, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "gemm_kernel", "ts": 2,
         "dur": 10.0, "args": {"device": 0, "stream": 7}},
        {"ph": "X", "cat": "kernel", "name": "gemm_kernel", "ts": 20,
         "dur": 30.0, "args": {"device": 0, "stream": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 60,
         "dur": 4.0, "args": {"device": 0, "stream": 7}},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 70},
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_device_events_form_the_gpu_plane(tmp_path):
    path = str(tmp_path / "x.pt.trace.json")
    _trace_with_kernels(path)
    rows = list(parse_trace(path))
    assert ("/device:GPU:0", "stream 7", "gemm_kernel", 10.0) in rows
    assert ("/host:CPU", "thread 1", "aten::mm", 50.0) in rows
    assert not any(name == "cudaLaunchKernel" for _, _, name, _ in rows)
    stats = kernel_summary(str(tmp_path))
    assert [(s.name, s.calls) for s in stats] == [("gemm_kernel", 2),
                                                  ("Memcpy DtoH", 1)]
    g = stats[0]
    assert (g.total_us, g.min_us, g.max_us, g.mean_us) == \
        (40.0, 10.0, 30.0, 20.0)
    every = kernel_summary(path, device_only=False)
    assert {s.plane for s in every} == {"/device:GPU:0", "/host:CPU"}
    assert [s.name for s in kernel_summary(path, name_filter="Memcpy")] \
        == ["Memcpy DtoH"]


def test_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        kernel_summary(str(tmp_path))
