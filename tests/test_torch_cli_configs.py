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


def test_speech_train_end_to_end(tmp_path):
    """``tests/test_cli.py``'s speech_train case: the four rows, a finite
    loss that fell, WERs in range. The beam decode's WER is read as a
    number only: on the undertrained model it may exceed 1 (insertions),
    a property of the model, not of the decoder."""
    rows = _run(tmp_path, "--config=speech_train", "--steps=3")
    by_id = {r["bench_id"]: r for r in rows}
    assert set(by_id) == {"speech_ctc_loss", "speech_wer_greedy",
                          "speech_wer_beam", "speech_wer_beam_lm"}
    loss = by_id["speech_ctc_loss"]
    assert loss["value"] > 0 and loss["device"] == "cpu"
    assert loss["value"] < loss["extra"]["first_loss"]
    assert loss["extra"]["epochs"] == 3 and loss["extra"]["n_utts"] == 6
    for mode in ("greedy", "beam_lm"):
        assert 0.0 <= by_id[f"speech_wer_{mode}"]["value"] <= 1.0
    assert by_id["speech_wer_beam"]["value"] >= 0.0


def test_speech_train_on_the_ldc93s1_import(tmp_path):
    """``--speech_data=ldc93s1``: the importer's fabricated stand-in
    (no corpus files here), one utterance, the four rows."""
    rows = _run(tmp_path, "--config=speech_train", "--steps=1",
                "--speech_data=ldc93s1")
    loss = next(r for r in rows if r["bench_id"] == "speech_ctc_loss")
    assert loss["extra"]["n_utts"] == 1 and np.isfinite(loss["value"])
    assert len(rows) == 4


def test_detection_train_rows(tmp_path):
    """``tosem_tpu/cli.py``'s ``detection_train`` rows on the tiny
    EfficientDet: AP50 with AP and the losses in ``extra``, then the step
    time; the loss falls over the steps."""
    rows = _run(tmp_path, "--config=detection_train", "--steps=3")
    assert [(r["bench_id"], r["metric"], r["unit"]) for r in rows] == [
        ("efficientdet_tiny_b2", "ap50", "AP"),
        ("efficientdet_tiny_b2", "step_time_ms", "ms")]
    ap = rows[0]
    assert 0.0 <= ap["value"] <= 1.0 and 0.0 <= ap["extra"]["ap"] <= 1.0
    assert ap["extra"]["steps"] == 3 and ap["device"] == "cpu"
    assert ap["extra"]["final_loss"] < ap["extra"]["first_loss"]
    assert rows[1]["value"] > 0 and rows[1]["extra"]["batch"] == 2


def test_detection_infer_rows_and_export(tmp_path):
    """Latency, host postprocess and the export row (``export_kb``, the
    ``.pt2`` the JAX package's ``stablehlo_kb`` row stands for); the
    program reloads and gives the tiny model's eval forward."""
    from tosem_tpu_torch.models.efficientdet import efficientdet_tiny
    rows = _run(tmp_path, "--config=detection_infer")
    assert [(r["bench_id"], r["metric"]) for r in rows] == [
        ("effdet_tiny_fwd_b1", "latency_ms"),
        ("effdet_tiny_post_b1", "postprocess_ms"),
        ("effdet_tiny_export", "export_kb")]
    assert all(r["value"] > 0 for r in rows)
    assert rows[1]["device"] == "cpu" and rows[1]["extra"]["nms"] == "host"
    paths = rows[2]["extra"]["paths"]
    assert [os.path.basename(p) for p in paths] == [
        "efficientdet_infer.meta", "efficientdet_infer.pt2"]
    assert open(paths[0]).read().splitlines() == [
        "in data f32 1 64 64 3", "out data f32 1 756 5",
        "out data f32 1 756 4"]
    x = torch.randn(1, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = torch.export.load(paths[1]).module()(x)
        want = efficientdet_tiny(device="cpu", seed=0).eval()(x)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=0, atol=1e-5 * float(w.abs().max()))


def test_pointpillars_infer_rows(tmp_path):
    rows = _run(tmp_path, "--config=pointpillars_infer")
    assert [(r["bench_id"], r["metric"]) for r in rows] == [
        ("pointpillars_apply_n256_4x4", "latency_ms"),
        ("pointpillars_detect_n256_4x4", "latency_ms")]
    assert rows[1]["extra"]["includes"] == "NMS sweep"
    for r in rows:
        assert r["value"] > 0 and r["extra"]["grid"] == [4, 4]
        assert r["extra"]["points"] == 256 and r["device"] == "cpu"


@pytest.mark.parametrize("config", ["detection_train", "detection_infer",
                                    "pointpillars_infer"])
def test_detection_configs_are_ported(config):
    from tosem_tpu_torch.cli import NOT_PORTED, RUNNERS
    assert config in RUNNERS and config not in NOT_PORTED
