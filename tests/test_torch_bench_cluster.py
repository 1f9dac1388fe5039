"""The cluster serving and control-plane microbenches
(``serve/bench_cluster.py``) on the CPU, at their smallest sizes.

Each leg raises on the reference's answer checks (zero client errors
across a node kill, full re-placement, sharded answers equal to the
unsharded kernel byte for byte, hedges that fire and no errors under a
gray node, disaggregated ≡ colocated streams with migrations, drains
that lose no work, the control loop's typed sheds, scale-up,
convergence and zero cold serves), so a run that returns its rows
passed them. The reference's wall-clock bounds (failover recovery ≥
0.5x, hedged p99 < 0.8x the injected delay, steady p99 under the SLO
budget) are reported on their rows, never raised on: under a loaded
host they measure the host (C-ref2). ``ControlLoadBackend`` is the
bench module's own, which ``test_torch_control.py`` deploys by name;
its warm/cold accounting is held here against the reference's copy.
"""
import pytest
import torch

from tosem_tpu_torch.serve import bench_cluster as bc

torch.set_num_threads(1)


def _by_id(rows):
    return {r.bench_id: r for r in rows}


def test_router_failover_and_parity_legs():
    only = {"cluster_router_c16", "cluster_single_ref_c16",
            "cluster_vs_single", "cluster_failover_recovery",
            "cluster_failover_errors", "cluster_sharded_parity",
            "cluster_paged_parity"}
    rows = _by_id(bc.run_cluster_benchmarks(trials=1, min_s=0.1,
                                            quiet=True, only=only,
                                            device="cpu"))
    assert set(rows) == only
    assert rows["cluster_failover_errors"].value == 0.0
    rec = rows["cluster_failover_recovery"]
    assert 0 < rec.value <= 1.0
    assert rec.extra["reference_floor"] == 0.5
    assert rec.extra["floor_met"] == (rec.extra["raw_recovery"] >= 0.5)
    assert rec.extra["errors_through_kill"] == 0
    assert rec.extra["requests_through_kill"] > 0
    for bid in ("cluster_sharded_parity", "cluster_paged_parity"):
        assert rows[bid].value == 1.0
    assert rows["cluster_paged_parity"].extra["mesh"]


def test_hedge_leg():
    rows = _by_id(bc.run_cluster_benchmarks(
        trials=1, min_s=0.1, quiet=True, only=set(bc.HEDGE_BENCH_IDS),
        device="cpu"))
    assert set(rows) == set(bc.HEDGE_BENCH_IDS)
    hedged = rows["router_hedged_p99"].extra
    assert hedged["hedges_fired"] >= 1 and hedged["hedge_wins"] >= 1
    assert hedged["reference_ceiling_ms"] == pytest.approx(80.0)
    assert hedged["floor_met"] == (
        rows["router_hedged_p99"].value < 80.0)


@pytest.mark.parametrize("scenario", sorted(bc.CLUSTER_SCENARIOS))
def test_cluster_decode_scenarios(scenario):
    ids = set(bc.CLUSTER_SCENARIOS[scenario])
    rows = _by_id(bc.run_cluster_benchmarks(trials=1, min_s=0.1,
                                            quiet=True, only=ids,
                                            device="cpu"))
    assert set(rows) == ids
    if scenario == "decode":
        assert rows["cluster_decode_disagg_c16"].extra[
            "kv_migrations"] >= 1
        assert all(r.value > 0 for r in rows.values())
    else:
        assert rows["cluster_drain_errors"].value == 0.0
        drain = rows["cluster_drain_migrate_vs_readmit"]
        assert drain.value > 0
        assert drain.extra["drain_migrate"]["migrated"] >= 1


def test_control_scenario():
    rows = _by_id(bc.run_control_benchmarks(trials=1, min_s=0.1,
                                            quiet=True))
    assert set(rows) == set(bc.GATED_CONTROL_BENCHES)
    assert rows["control_steady_sheds"].value == 0.0
    assert rows["control_burst_scaleup"].value >= 2
    assert rows["control_replica_convergence"].value == 1.0
    assert rows["control_cold_serves"].value == 0.0
    p99 = rows["control_steady_p99_ms"]
    assert p99.value > 0
    assert p99.extra["reference_ceiling_ms"] == 500.0
    assert p99.extra["floor_met"] == (p99.value < 500.0)


def test_control_load_backend_accounts_like_the_reference_s():
    """The same calls on both packages' ``ControlLoadBackend``: a call
    before warmup is one cold serve, warmup marks it warm, stats agree."""
    from tosem_tpu.serve.bench_cluster import \
        ControlLoadBackend as RefBackend
    seen = []
    for cls in (bc.ControlLoadBackend, RefBackend):
        b = cls(delay_s=0.0, compile_s=0.0)
        trace = [b.stats(), b.call({"x": 3}), b.stats(), b.call({}),
                 b.warmup([1, 2]), b.stats()]
        fresh = cls(delay_s=0.0, compile_s=0.0)
        trace += [fresh.warmup([1]), fresh.call({"x": 1}), fresh.stats()]
        seen.append(trace)
    assert seen[0] == seen[1]
    assert seen[0][2] == {"cold_serves": 1, "warmed": True}
    assert seen[0][-1] == {"cold_serves": 0, "warmed": True}


def test_module_loads_without_torch():
    """A replica imports ``ControlLoadBackend`` by name: the module's top
    level must not pull in torch or numpy."""
    import subprocess
    import sys
    code = ("import sys; import tosem_tpu_torch.serve.bench_cluster; "
            "print(sorted(m for m in ('torch', 'numpy') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
