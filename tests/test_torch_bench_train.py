"""The distributed-training microbench (``train/bench_train.py``) on the
CPU, and the CLI configs of this slice's benches.

The train bench's three legs at one round: the dp-4 parity pin raises
unless the threads backend's losses equal the local fold's, and the two
ratio rows carry the reference's speed floors (overlap ≥ 1.3x, async
saving ≥ 0.8) beside them, reported, never raised. The CLI's
``autotune_decode_pages``, ``train_bench`` and ``control_bench`` run
with ``--device=cpu`` in a subprocess (from a temporary directory, so
the autotune cache lands there); ``decode_bench``, ``decode_scenarios``
and ``cluster_bench`` are held by their benches' own tests and here by
what their runners pass on.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from tosem_tpu_torch import cli
from tosem_tpu_torch.train import bench_train as bt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_CONFIGS = ("decode_bench", "decode_scenarios",
                 "autotune_decode_pages", "cluster_bench", "control_bench",
                 "train_bench")


def test_train_bench_legs():
    rows = {r.bench_id: r for r in bt.run_train_benchmarks(
        trials=1, min_s=0.1, quiet=True, device="cpu")}
    assert set(rows) == {"train_dp_parity", "train_step_overlap",
                         "train_step_serial", "train_overlap_speedup",
                         "train_ckpt_sync_overhead_ms",
                         "train_ckpt_async_overhead_ms",
                         "train_ckpt_async_saving"}
    assert rows["train_dp_parity"].value == 1.0
    for bid, floor in bt.SPEED_FLOORS.items():
        assert rows[bid].extra["reference_floor"] == floor
        assert rows[bid].extra["floor_met"] == (rows[bid].value >= floor)
    assert all(rows[b].value > 0 for b in ("train_step_overlap",
                                           "train_step_serial",
                                           "train_ckpt_sync_overhead_ms"))


def test_train_bench_subset():
    rows = bt.run_train_benchmarks(trials=1, min_s=0.1, quiet=True,
                                   device="cpu", only={"train_dp_parity"})
    assert [r.bench_id for r in rows] == ["train_dp_parity"]


def test_the_slice_s_configs_are_ported():
    for name in SLICE_CONFIGS:
        assert name in cli.RUNNERS and name not in cli.NOT_PORTED


@pytest.mark.parametrize("config,target,want", [
    ("decode_bench", "tosem_tpu_torch.serve.bench_decode."
     "run_decode_benchmarks", dict(preset="base", device="cpu",
                                   only=None)),
    ("decode_scenarios", "tosem_tpu_torch.serve.bench_decode."
     "run_decode_benchmarks", dict(preset="base", device="cpu")),
    ("cluster_bench", "tosem_tpu_torch.serve.bench_cluster."
     "run_cluster_benchmarks", dict(device="cpu"))])
def test_runners_pass_the_device_and_tag_their_rows(monkeypatch, config,
                                                    target, want):
    import importlib

    from tosem_tpu_torch.utils.results import ResultRow
    mod_name, fn = target.rsplit(".", 1)
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return [ResultRow(project="runtime", config="microbenchmark",
                          bench_id="x", metric="m", value=1.0, unit="x",
                          device="cpu")]
    monkeypatch.setattr(importlib.import_module(mod_name), fn, fake)
    args = cli.make_parser().parse_args(["--preset=base"])
    rows = cli.RUNNERS[config](args, torch.device("cpu"))
    assert [r.config for r in rows] == [config]
    for k, v in want.items():
        assert seen.get(k) == v, (k, seen)
    if config == "decode_scenarios":
        from tosem_tpu_torch.serve.bench_decode import SCENARIO_BENCHES
        assert seen["only"] == {b for ids in SCENARIO_BENCHES.values()
                                for b in ids}


def _cli(tmp_path, *args):
    return subprocess.run([sys.executable, "-m", "tosem_tpu_torch.cli",
                           "--device=cpu", *args], cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ROOT})


def test_cli_autotune_decode_pages_on_cpu(tmp_path):
    from tosem_tpu.utils.results import read_results
    out = _cli(tmp_path, "--config=autotune_decode_pages",
               "--results_csv=rows.csv")
    assert out.returncode == 0, out.stderr
    rows = read_results(str(tmp_path / "rows.csv"))
    assert {r["bench_id"] for r in rows} == {
        "decode_pages_b2_t128_float32_p64",
        "decode_pages_b2_t128_float32_p128"}
    cache = json.load(open(tmp_path / "results" /
                           "flash_blocks_torch.json"))
    assert list(cache) == ["pages"]
    assert list(cache["pages"]) == ["cpu/torch/decode_d32_float32"]
    assert cache["pages"]["cpu/torch/decode_d32_float32"] in (64, 128)


@pytest.mark.parametrize("config,rows_want", [
    ("train_bench", 7), ("control_bench", 5)])
def test_cli_host_benches_on_cpu(tmp_path, config, rows_want):
    from tosem_tpu.utils.results import read_results
    out = _cli(tmp_path, f"--config={config}", "--results_csv=rows.csv")
    assert out.returncode == 0, out.stderr
    rows = read_results(str(tmp_path / "rows.csv"))
    assert len(rows) == rows_want
    assert {r["config"] for r in rows} == {config}
