"""The port's BERT kernel suite, result rows, roofline and experiment
runner held against the JAX package's: the same FLOP and byte models,
the same ``bench_id``s, units and ``extra`` keys, one CSV schema that
either package reads back. The suite runs its plain versions on the CPU
at the JAX package's CPU shapes (``tosem_tpu/cli.py:311-313``) with one
call per timing; the reference's suite is run with its timer replaced,
so only its rows' shapes and models are compared, never its times."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_SHAPES = dict(batch=1, seq=128, heads=2, head_dim=32, hidden=64)


@pytest.mark.parametrize("T", [64, 128, 300, 512, 2048])
@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 128), (64, 128),
                                   (128, 64), (512, 512)])
def test_causal_fraction_and_flops_equal_the_reference(T, bq, bk):
    from tosem_tpu.ops import kernel_suite as ref
    from tosem_tpu_torch.ops import kernel_suite as port
    frac = port.causal_block_fraction(T, bq, bk)
    assert frac == ref.causal_block_fraction(T, bq, bk)
    for bwd in (False, True):
        assert (port.attention_flops(8, 12, T, 64, bwd=bwd,
                                     causal_fraction=frac)
                == ref.attention_flops(8, 12, T, 64, bwd=bwd,
                                       causal_fraction=frac))


def test_select_block_sizes_returns_the_cuda_tiles():
    from tosem_tpu_torch.ops import flash_blocks
    from tosem_tpu_torch.ops.kernel_suite import causal_block_fraction
    for T, dtype in ((512, "bfloat16"), (128, "float32"), (8192, "bfloat16")):
        b = flash_blocks.select_block_sizes(T, 64, dtype)
        assert b.as_list() == [64, 64, 64, 64]
        assert flash_blocks.select_block_sizes.last_source == "fixed"
    # the fraction the port's FLOP model uses at the north-star shape
    assert causal_block_fraction(512, b.bq, b.bk) == 36 / 64
    # the tiles are the kernels' own constants
    src = open(os.path.join(ROOT, "tosem_tpu_torch", "ops", "csrc",
                            "flash_bwd.cu")).read()
    assert "constexpr int BR = 64;" in src and "constexpr int BS = 64;" in src
    src = open(os.path.join(ROOT, "tosem_tpu_torch", "ops", "csrc",
                            "flash_fwd.cu")).read()
    assert "constexpr int BQ = 64;" in src and "constexpr int BK = 64;" in src


class _FixedTimer:
    """Stands in for the reference's DeviceLoopBench: 1 ms a call, the op
    never runs (its rows' shapes and models are what is compared)."""

    def __init__(self, op, args, perturb=0):
        pass

    def time(self, **_):
        return 1e-3


@pytest.fixture(scope="module")
def suites():
    import importlib
    ref = importlib.import_module("tosem_tpu.ops.kernel_suite")
    from tosem_tpu_torch.ops.kernel_suite import bert_kernel_suite
    real = ref.DeviceLoopBench
    ref.DeviceLoopBench = _FixedTimer
    try:
        want = ref.bert_kernel_suite(**CPU_SHAPES)
    finally:
        ref.DeviceLoopBench = real
    got = bert_kernel_suite(**CPU_SHAPES, n_iter=1, reps=1, device="cpu")
    return ({r.bench_id: r for r in want}, {r.bench_id: r for r in got})


def test_suite_emits_the_reference_rows(suites):
    want, got = suites
    assert sorted(got) == sorted(want)
    assert len(got) == 10
    for bid, w in want.items():
        g = got[bid]
        assert (g.project, g.config, g.metric, g.unit) == \
            (w.project, w.config, w.metric, w.unit), bid
        assert set(g.extra) == set(w.extra), bid
        assert g.device == "cpu" and g.n_devices == 1
        assert g.value > 0 and g.extra["time_us"] > 0


def test_suite_flop_and_byte_models_match_the_reference(suites):
    """Byte rows: the same bytes. FLOP rows: the same model; the causal
    rows' fraction comes from each package's own tiles (the port's
    64 x 64 CUDA tiles), and the row's FLOPs are that model's count."""
    from tosem_tpu_torch.ops.kernel_suite import (attention_flops,
                                                  causal_block_fraction)
    want, got = suites
    B, H, T, D = 1, 2, 128, 32
    frac = causal_block_fraction(T, 64, 64)
    for bid, w in want.items():
        g = got[bid]
        assert g.extra["dtype"] == w.extra["dtype"] == "bfloat16"
        if w.unit == "GB/s":
            assert g.extra["bytes"] == w.extra["bytes"]
            continue
        assert g.extra["shape"] == w.extra["shape"] == [B, H, T, D]
        flops = g.value * 1e9 * g.extra["time_us"] / 1e6
        if "causal" in bid:
            assert g.extra["causal_fraction"] == frac
            fwd = attention_flops(B, H, T, D, bwd=False,
                                  causal_fraction=frac)
            model = fwd if "fwdbwd" not in bid else (
                attention_flops(B, H, T, D, bwd=True, causal_fraction=frac))
            assert flops == pytest.approx(model, rel=1e-9)
            continue
        assert g.extra["flop_model"] == w.extra["flop_model"]
        w_flops = w.value * 1e9 * w.extra["time_us"] / 1e6
        assert flops == pytest.approx(w_flops, rel=1e-9)
        if "xla" in bid:
            assert w.extra["path"] == "xla" and g.extra["path"] == "dense"
        else:
            assert g.extra["blocks"] == [64, 64, 64, 64]
            assert g.extra["blocks_src"] == "fixed"


def test_result_rows_share_the_reference_schema(tmp_path):
    from tosem_tpu.utils import results as ref
    from tosem_tpu_torch.utils import results as port
    assert port.SCHEMA == ref.SCHEMA
    assert ([f.name for f in dataclasses.fields(port.ResultRow)]
            == [f.name for f in dataclasses.fields(ref.ResultRow)])
    row = port.ResultRow(project="ops", config="bert_kernel_suite",
                         bench_id="layernorm_fwd_4096x768_bfloat16",
                         metric="gbps", value=1234.5, unit="GB/s",
                         extra={"bytes": 12582912, "time_us": 10.19})
    assert row.to_csv_dict().keys() == ref.ResultRow(
        **dataclasses.asdict(row)).to_csv_dict().keys()
    path = str(tmp_path / "rows.csv")
    with port.ResultWriter(path) as w:
        w.add(row)
    back = ref.read_results(path)
    assert len(back) == 1 and back[0]["bench_id"] == row.bench_id
    assert back[0]["value"] == row.value and back[0]["device"] == "gpu"
    assert back[0]["extra"] == row.extra
    assert port.read_results(path) == back


@pytest.mark.parametrize("unit,dtype,value,key,peak", [
    ("GFLOPS", "bfloat16", 98_900.0, "mfu", 989_000.0),
    ("GFLOPS", "float32", 6_700.0, "mfu", 67_000.0),
    ("GB/s", "bfloat16", 1_675.0, "mbu", 3_350.0)])
def test_annotate_roofline_uses_the_h100_peaks(unit, dtype, value, key,
                                               peak):
    from tosem_tpu_torch.utils import roofline
    from tosem_tpu_torch.utils.results import ResultRow
    row = ResultRow(project="ops", config="c", bench_id="b", metric="m",
                    value=value, unit=unit, extra={"dtype": dtype})
    roofline.annotate_roofline(row)
    assert row.extra[key] == round(value / peak, 4)
    assert row.extra["bound"] == ("memory" if unit == "GB/s" else "compute")
    assert roofline.PEAK_HBM_GBPS == 3_350.0


def test_annotate_roofline_classifies_by_the_per_call_times():
    from tosem_tpu_torch.utils.roofline import annotate_roofline
    from tosem_tpu_torch.utils.results import ResultRow
    # 1 GFLOP over 100 MB in 100 us: 30 us of bytes beat 1 us of FLOPs
    row = ResultRow(project="ops", config="c", bench_id="b", metric="m",
                    value=1e9 / 100e-6 / 1e9, unit="GFLOPS",
                    extra={"dtype": "bfloat16", "bytes": 100e6,
                           "time_us": 100.0})
    annotate_roofline(row)
    assert row.extra["bound"] == "memory"
    assert row.extra["mbu"] == round(100e6 / 100e-6 / 1e9 / 3350.0, 4)


def test_device_loop_bench_times_on_the_host_for_cpu_tensors():
    from tosem_tpu_torch.utils.timing import (DeviceLoopBench, gflops,
                                              matmul_flops)
    calls = []
    x = torch.ones(4)
    sec = DeviceLoopBench(op=lambda a: calls.append(a) or a * 2,
                          args=(x,)).time(n_iter=3, reps=2)
    assert sec > 0 and len(calls) == 1 + 3 * 2     # warm-up, then 2 x 3
    assert matmul_flops(2, 3, 4) == 48.0
    assert gflops(2e9, 2.0) == 1.0


def test_sparse_suite_names_its_roadmap_item(capsys):
    """The flash_sparse leg runs (plain versions on the CPU) without a
    block sweep, and says that block selection is ROADMAP.md A4."""
    import argparse
    from tosem_tpu_torch import cli
    rows = cli.run_flash_sparse(argparse.Namespace(batch=None, seq=128),
                                torch.device("cpu"))
    assert len(rows) == 6
    assert {r.extra["blocks_src"] for r in rows} == {"fixed"}
    assert "ROADMAP.md A4" in capsys.readouterr().out


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "tosem_tpu_torch.cli",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": ROOT})


def test_cli_writes_the_suite_csv_on_cpu(tmp_path):
    from tosem_tpu.utils.results import read_results
    path = str(tmp_path / "torch_kernels.csv")
    out = _cli("--device=cpu", "--config=bert_kernels",
               f"--results_csv={path}",)
    assert out.returncode == 0, out.stderr
    rows = read_results(path)
    assert len(rows) == 10
    assert {r["device"] for r in rows} == {"cpu"}
    assert "attention_fwd_b1_t128_bfloat16" in {r["bench_id"] for r in rows}
    launches = json.loads(out.stdout.split("kernel launches ")[1]
                          .splitlines()[0])
    assert launches == {}            # the CPU runs the plain versions only


@pytest.mark.parametrize("argv,item", [
    (["--device=cpu", "--config=chaos"], "A14"),
    (["chaos", "--device=cpu"], "A14"),
    (["--device=cpu", "--config=flash_autotune"], "A4"),
    (["--device=cpu", "--config=analysis"], "A12")])
def test_cli_names_the_roadmap_item_of_an_unported_config(argv, item):
    out = _cli(*argv)
    assert out.returncode == 2
    assert "ROADMAP.md" in out.stderr and item in out.stderr


def test_cli_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    out = _cli("--config=bert_kernels",
               f"--results_csv={tmp_path / 'x.csv'}")
    assert out.returncode == 1 and "cuda" in out.stderr
    assert not (tmp_path / "x.csv").exists()
