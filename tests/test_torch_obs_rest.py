"""The rest of the port's ``obs/``: the dashboard, the log monitor and
sysmo, held to the JAX package's own tests.

Copies, against :mod:`tosem_tpu_torch.obs`, of the dashboard tests of
``tests/test_components_dashboard.py`` (``TestDashboard``,
``TestDashboardCharts``, ``TestInteractiveDashboard``; the served
deployments test stays ``slow``, as there) and of ``tests/test_obs.py``'s
``TestLogMonitor`` and ``TestSysMo``. Every HTTP server binds port 0 and
is shut down in ``finally``. The drive view's tests are in
``tests/test_torch_driving.py``.
"""
import json
import urllib.request

import pytest

from tosem_tpu_torch.obs import (DashboardServer, counter, render_html,
                                 render_text, snapshot)


class TestDashboard:
    def test_snapshot_and_renderers(self, tmp_path):
        c = counter("dash_test_total", "test counter")
        c.inc(3)
        snap = snapshot()
        assert any(m["series"].startswith("dash_test_total")
                   for m in snap["metrics"])
        assert snap["memory"]["rss_bytes"] > 0
        txt = render_text(snap)
        assert "dash_test_total" in txt and "memory" in txt
        page = render_html(snap)
        assert "<html>" in page and "dash_test_total" in page

    def test_malformed_results_csv_degrades(self, tmp_path):
        bad = tmp_path / "bad.csv"
        bad.write_text("not,a,results\nschema,at,all\n")
        snap = snapshot(results_csv=str(bad))
        assert snap["results"] == []
        assert "results_error" in snap
        render_text(snap)                 # must not raise
        render_html(snap)

    @pytest.mark.slow
    def test_snapshot_includes_serve_deployments(self):
        import tosem_tpu_torch.runtime as rt
        from tosem_tpu_torch.serve import Serve
        rt.init(num_workers=1)
        try:
            s = Serve()

            class Echo:
                def call(self, r):
                    return r

            s.deploy("dash-echo", Echo, num_replicas=2)
            snap = snapshot(serve=s)
            dep = next(d for d in snap["deployments"]
                       if d["name"] == "dash-echo")
            assert dep["replicas"] == 2 and dep["load"] == 0
            assert "dash-echo" in render_text(snap)
            assert "dash-echo" in render_html(snap)
        finally:
            rt.shutdown()

    def test_server_endpoints(self, tmp_path):
        from tosem_tpu_torch.tune.experiment import ExperimentManager
        db = str(tmp_path / "hpo.db")
        ExperimentManager(path=db).create({
            "name": "dash-exp",
            "trainable": "tosem_tpu_torch.tune.examples:quadratic",
            "space": {"x": {"type": "uniform", "low": 0, "high": 1}},
            "metric": "loss", "mode": "min"})
        srv = DashboardServer(kv_path=db)
        try:
            api = json.loads(urllib.request.urlopen(
                srv.url + "/api", timeout=10).read())
            assert api["experiments"][0]["name"] == "dash-exp"
            html_page = urllib.request.urlopen(
                srv.url + "/", timeout=10).read().decode()
            assert "dash-exp" in html_page
            prom = urllib.request.urlopen(
                srv.url + "/metrics", timeout=10).read().decode()
            assert "# TYPE" in prom or prom.strip()
        finally:
            srv.shutdown()


class TestDashboardCharts:
    def test_svg_charts_render(self):
        """Experiments with trial scores and result series get inline SVG
        charts (the WebUI default-metric plot, server-rendered)."""
        snap = {
            "timestamp": 0.0,
            "runtime": None,
            "memory": {"rss_bytes": 1e6, "available_bytes": 1e9},
            "metrics": [],
            "experiments": [{"name": "exp1", "status": "done",
                             "best_score": 0.2, "n_trials": 4,
                             "trial_scores": [0.9, 0.5, 0.3, 0.2]}],
            "deployments": [],
            "results": [{"config": "gemm", "bench_id": f"g{i}",
                         "metric": "gflops", "value": 100.0 + i,
                         "unit": "GFLOPS", "device": "tpu"}
                        for i in range(3)],
        }
        page = render_html(snap)
        assert page.count("<svg") == 2          # one per chart family
        assert "best score per trial" in page
        assert "gemm/gflops" in page

    def test_no_charts_for_sparse_data(self):
        snap = {
            "timestamp": 0.0, "runtime": None,
            "memory": {"rss_bytes": 1e6, "available_bytes": 1e9},
            "metrics": [],
            "experiments": [{"name": "e", "status": "running",
                             "best_score": None, "n_trials": 1,
                             "trial_scores": [0.5]}],   # 1 point: no chart
            "deployments": [], "results": [],
        }
        assert "<svg" not in render_html(snap)


class TestInteractiveDashboard:
    """The interactive layer: live-poll script served with the page,
    per-experiment trial drill-down endpoint, table ids for in-place
    re-render (the NNI WebUI role beyond static SVG)."""

    def test_page_carries_live_script_and_table_ids(self, tmp_path):
        import urllib.request
        from tosem_tpu_torch.obs import DashboardServer
        srv = DashboardServer(kv_path=str(tmp_path / "kv.db"))
        try:
            page = urllib.request.urlopen(srv.url, timeout=30).read().decode()
            assert 'id="t-results"' in page and 'id="t-exp"' in page
            assert 'fetch("/api")' in page          # live polling
            assert 'id="pause"' in page             # pause control
            assert "/api/experiment/" in page       # drill-down wiring
        finally:
            srv.shutdown()

    def test_experiment_drilldown_endpoint(self, tmp_path):
        import json as _json
        import urllib.request
        from tosem_tpu_torch.tune.experiment import ExperimentManager
        from tosem_tpu_torch.obs import DashboardServer
        db = str(tmp_path / "kv.db")
        mgr = ExperimentManager(path=db)
        mgr.create({"name": "exp1", "trainable": "x:y",
                    "space": {}, "metric": "m", "mode": "max"})
        mgr._set_state("exp1", {
            "status": "done",
            "trials": [{"trial_id": "t0", "status": "SUCCEEDED",
                        "score": 0.9, "config": {"x": 1}}]})
        srv = DashboardServer(kv_path=db)
        try:
            out = _json.loads(urllib.request.urlopen(
                srv.url + "/api/experiment/exp1", timeout=30).read())
            assert out["name"] == "exp1"
            assert out["trials"][0]["trial_id"] == "t0"
            missing = _json.loads(urllib.request.urlopen(
                srv.url + "/api/experiment/nope", timeout=30).read())
            assert missing["trials"] == []          # unknown -> empty
        finally:
            srv.shutdown()

    def test_sysmo_gauges_reach_the_metrics_panel(self, tmp_path):
        """DashboardServer(sysmo=True): the health checker's gauges ride
        the same /metrics endpoint and metrics table as everything else."""
        import time as _t
        import urllib.request
        from tosem_tpu_torch.obs import DashboardServer
        srv = DashboardServer(kv_path=str(tmp_path / "kv.db"), sysmo=True)
        try:
            deadline = _t.monotonic() + 20
            text = ""
            while _t.monotonic() < deadline:
                text = urllib.request.urlopen(
                    srv.url + "/metrics", timeout=30).read().decode()
                if "sysmo_rss_bytes" in text:
                    break
                _t.sleep(0.2)
            assert "sysmo_rss_bytes" in text
            assert "sysmo_threads" in text
        finally:
            srv.shutdown()


class TestLogMonitor:
    def test_tails_appended_lines(self, tmp_path):
        from tosem_tpu_torch.obs import LogMonitor
        lines = []
        mon = LogMonitor(sink=lambda tag, line: lines.append((tag, line)))
        p = tmp_path / "worker-1.log"
        p.write_text("first\n")
        mon.add_file(str(p), tag="w1")
        mon.poll_once()
        with open(p, "a") as f:
            f.write("second\nthird\n")
        mon.poll_once()
        assert ("w1", "first") in lines
        assert ("w1", "second") in lines and ("w1", "third") in lines


class TestSysMo:
    """obs/sysmo.py — the cyber/sysmo checker role: periodic process/
    scheduler health snapshots with pluggable subsystem sources."""

    def test_sample_fields_and_history_bound(self):
        from tosem_tpu_torch.obs.sysmo import SysMo
        sm = SysMo(interval_s=0.01, history=5)
        for _ in range(8):
            snap = sm.sample()
        assert snap["rss_bytes"] > 0
        assert snap["n_threads"] >= 1
        assert any(t["name"] == "MainThread" for t in snap["threads"])
        assert len(sm.snapshots) == 5          # bounded history

    def test_checker_thread_and_sources(self):
        import time as _t
        from tosem_tpu_torch.obs.sysmo import SysMo
        sm = SysMo(interval_s=0.01)
        sm.add_source("queue", lambda: {"depth": 3})
        sm.add_source("sick", lambda: 1 / 0)
        sm.start()
        deadline = _t.monotonic() + 10
        while len(sm.snapshots) < 3 and _t.monotonic() < deadline:
            _t.sleep(0.01)
        sm.stop()
        assert len(sm.snapshots) >= 3
        snap = sm.snapshots[-1]
        assert snap["queue"] == {"depth": 3}
        assert "ZeroDivisionError" in snap["sick"]["error"]
        assert "sysmo @" in sm.dump() and "queue" in sm.dump()

    def test_gauges_feed_registry(self):
        from tosem_tpu_torch.obs.metrics import Registry
        from tosem_tpu_torch.obs.sysmo import SysMo
        reg = Registry()
        sm = SysMo(registry=reg)
        sm.sample()
        text = "\n".join(l for m in reg._metrics.values()
                         for l in m.collect())
        assert "sysmo_rss_bytes" in text and "sysmo_threads" in text

    def test_node_agent_stats_as_source(self):
        """The scheduler-hook analog: a node agent's stats RPC joins the
        sysmo report."""
        from tosem_tpu_torch.cluster.node import RemoteNode
        from tosem_tpu_torch.obs.sysmo import SysMo
        node = RemoteNode.spawn_local(num_workers=1)
        try:
            sm = SysMo()
            sm.add_source("agent", node.stats)
            snap = sm.sample()
            assert snap["agent"]["num_workers"] == 1
        finally:
            node.kill()
