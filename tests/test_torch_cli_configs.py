"""The port's CLI runs north-star configs 1, 2 and 4, ``bert_train``
(with its kernel summary), ``kernel_matrix`` and the ``microbench``
subcommand on the CPU (``--device=cpu``, one timed step, a small batch)
and writes rows whose ``bench_id``s are the JAX package's for the same
config. ``bert_train``'s flash and dense arms give the same losses
(``tests/test_cli.py``'s ``test_bert_train_ab_loss_parity``)."""
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _run(tmp_path, *argv):
    from tosem_tpu_torch.cli import main
    from tosem_tpu_torch.utils.results import read_results
    path = str(tmp_path / "rows.csv")
    assert main(["--device=cpu", f"--results_csv={path}", *argv]) == 0
    return read_results(path)


def test_gemm_and_timing_check_rows(tmp_path):
    from tosem_tpu.ops.gemm import GemmSpec
    rows = _run(tmp_path, "--config=gemm,timing_check")
    base = GemmSpec(256, 256, 256, "float32", "float32").bench_id
    assert [r["bench_id"] for r in rows] == [
        base, f"{base}_deviceloop", f"{base}_batch", f"{base}_agreement"]
    assert [r["config"] for r in rows] == ["gemm"] + ["timing_check"] * 3
    assert all(r["value"] > 0 and r["device"] == "cpu" for r in rows)
    assert rows[0]["extra"]["timing"] == "host"
    assert rows[-1]["unit"] == "x"


def test_conv_sweep_row(tmp_path):
    rows = _run(tmp_path, "--config=conv_sweep")
    assert [r["bench_id"] for r in rows] == [
        "conv_cpu_3x3_b2_28x28x32_k3x3s1_32_float32"]
    assert rows[0]["unit"] == "GFLOPS" and rows[0]["value"] > 0


def test_resnet_train_rows(tmp_path):
    rows = _run(tmp_path, "--config=resnet_train", "--steps=1",
                "--batch=2")
    assert [(r["bench_id"], r["metric"]) for r in rows] == [
        ("resnet50_cifar_b2", "step_time_ms"),
        ("resnet50_cifar_b2", "images_per_sec")]
    assert np.isfinite(rows[0]["extra"]["final_loss"])
    assert rows[0]["extra"]["steps"] == 1
    assert not (tmp_path / "profile").exists()


def test_resnet_train_profile_writes_the_kernel_summary(tmp_path):
    from tosem_tpu_torch.profiler.trace import KERNEL_CSV_COLUMNS
    rows = _run(tmp_path, "--config=resnet_train", "--steps=1",
                "--batch=2", "--profile")
    assert [r["metric"] for r in rows] == ["step_time_ms", "images_per_sec"]
    summary = (tmp_path / "profile" / "resnet_train_cpu" /
               "kernel_summary.csv").read_text().splitlines()
    assert summary[0].split(",") == KERNEL_CSV_COLUMNS
    # a CPU capture falls back to the host's ops: the convolutions show
    assert any("conv" in line for line in summary[1:])


def test_bert_train_rows_and_kernel_summary(tmp_path):
    from tosem_tpu_torch.profiler.trace import KERNEL_CSV_COLUMNS
    rows = _run(tmp_path, "--config=bert_train", "--steps=1", "--profile")
    ids = [(r["bench_id"], r["metric"]) for r in rows]
    assert ids == [("bert_tiny_b2_t64_xla", "step_time_ms"),
                   ("bert_tiny_b2_t64_xla", "train_gflops"),
                   ("bert_tiny_b2_t64_flash", "step_time_ms"),
                   ("bert_tiny_b2_t64_flash", "train_gflops"),
                   ("bert_b2_t64_flash_vs_xla", "speedup")]
    summary = tmp_path / "profile" / "bert_train_cpu" / "kernel_summary.csv"
    header = summary.read_text().splitlines()[0].split(",")
    assert header == KERNEL_CSV_COLUMNS
    assert len(summary.read_text().splitlines()) > 1


def test_bert_train_remat_rows_carry_the_tag(tmp_path):
    rows = _run(tmp_path, "--config=bert_train", "--steps=1",
                "--remat=full")
    assert rows[0]["bench_id"] == "bert_tiny_b2_t64_xla_remat-full"
    assert rows[0]["extra"]["remat"] == "full"


def test_bert_train_ab_loss_parity():
    from tosem_tpu_torch.cli import make_parser, run_bert_train
    args = make_parser().parse_args(["--device=cpu", "--steps=1"])
    rows = run_bert_train(args, torch.device("cpu"))
    losses = {r.extra["attn"]: r.extra["final_loss"]
              for r in rows if r.metric == "step_time_ms"}
    assert set(losses) == {"xla", "flash"}
    assert abs(losses["xla"] - losses["flash"]) < 1e-4
    assert sum(r.metric == "train_gflops" for r in rows) == 2
    assert any(r.metric == "speedup" for r in rows)


def test_kernel_matrix_rows(tmp_path):
    rows = _run(tmp_path, "--config=kernel_matrix")
    assert [r["bench_id"] for r in rows] == [
        "kernels_flash_torch", "kernels_paged_torch",
        "kernels_schedule_torch"]
    assert {r["config"] for r in rows} == {"kernel_matrix"}
    for r in rows:
        assert r["extra"]["timing"] == "host"
        assert r["extra"]["on_chip"] is False
        assert r["extra"]["skipped_backends"] == ["cuda"]


@pytest.mark.parametrize("suite,ids", [
    ("--kernels", {"kernels_flash_torch", "kernels_paged_torch",
                   "kernels_schedule_torch"}),
    ("--sparse", {"sparse_causal_t256", "sparse_local_t256",
                  "sparse_local_speedup_t256"})])
def test_microbench_subcommand_runs_the_suites(suite, ids, tmp_path,
                                               capsys):
    from tosem_tpu_torch.cli import main
    base = str(tmp_path / "base.json")
    assert main(["microbench", suite, "--device=cpu",
                 "--trials", "1", "--min-s", "0.02", "--save", base]) == 0
    import json
    assert set(json.load(open(base))["benches"]) == ids


def test_a_missing_card_exits_1(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from tosem_tpu_torch.cli import main
    assert main(["--config=gemm",
                 f"--results_csv={tmp_path / 'x.csv'}"]) == 1
    assert not os.path.exists(tmp_path / "x.csv")
