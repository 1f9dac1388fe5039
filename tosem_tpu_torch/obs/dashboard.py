"""Cluster/experiment dashboard (the Ray dashboard role, minimal).

The reference ships a web dashboard fed by per-node agents
(`python/ray/new_dashboard/` — node stats, actor tables, metrics
graphs). Single-host translation: one :func:`snapshot` gathers runtime
scheduler stats, the metrics registry, process memory, experiment state
from the shared KV, and recent study-schema result rows; renderers emit
plain text (terminal) or a self-contained HTML page; and
:class:`DashboardServer` serves ``/`` (HTML), ``/api`` (JSON), and
``/metrics`` (Prometheus text) from a background thread, and ``/drive``
(the drive view, :mod:`~tosem_tpu_torch.obs.driveview`).

A copy of the JAX package's ``obs/dashboard.py`` over the port's
runtime, ``tune/`` experiment store and results CSVs.
"""
from __future__ import annotations

import html
import json
import time
from typing import Any, Dict, List, Optional

from tosem_tpu_torch.obs import metrics as _metrics
from tosem_tpu_torch.obs.memory_monitor import (read_available_bytes,
                                                 read_rss_bytes)


def snapshot(*, kv_path: Optional[str] = None,
             results_csv: Optional[str] = None,
             max_results: int = 20,
             experiments_manager: Any = None,
             serve: Any = None) -> Dict[str, Any]:
    """One coherent view of the system (the dashboard's data plane)."""
    snap: Dict[str, Any] = {"timestamp": time.time()}

    try:
        import tosem_tpu_torch.runtime as rt
        snap["runtime"] = rt.stats() if rt.is_initialized() else None
    except Exception as e:           # a dying runtime must not kill the UI
        snap["runtime"] = {"error": repr(e)}

    snap["memory"] = {"rss_bytes": read_rss_bytes(),
                      "available_bytes": read_available_bytes()}

    metr: List[Dict[str, Any]] = []
    for line in _metrics.prometheus_text().splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            metr.append({"series": name, "value": float(value)})
    snap["metrics"] = metr

    try:
        mgr = experiments_manager
        if mgr is None and kv_path is not None:
            from tosem_tpu_torch.tune.experiment import ExperimentManager
            mgr = ExperimentManager(path=kv_path)
        if mgr is not None:
            # mgr.list() already carries the full state incl. trials —
            # build the default-metric chart series (best score per
            # trial, NNI WebUI's headline plot) without re-reading
            snap["experiments"] = [
                dict({k: e.get(k) for k in ("name", "status",
                                            "best_score", "n_trials")},
                     trial_scores=[t.get("best_score")
                                   for t in (e.get("trials") or [])])
                for e in mgr.list()]
        else:
            snap["experiments"] = []
    except Exception as e:       # bad/locked db must not kill the UI
        snap["experiments"] = [{"error": repr(e)}]

    try:
        if serve is not None:
            snap["deployments"] = [
                {"name": n, "replicas": dep.num_replicas,
                 "load": dep.load()}
                for n, dep in sorted(serve.deployments().items())]
        else:
            snap["deployments"] = []
    except Exception as e:       # torn-down serve must not kill the UI
        snap["deployments"] = [{"error": repr(e)}]

    if results_csv is not None:
        try:
            from tosem_tpu_torch.utils.results import read_results
            rows = read_results(results_csv)[-max_results:]
            snap["results"] = [{k: r.get(k) for k in
                                ("config", "bench_id", "metric", "value",
                                 "unit", "device")} for r in rows]
        except Exception as e:       # a malformed CSV must not 500 the UI
            snap["results"] = []
            snap["results_error"] = repr(e)
    else:
        snap["results"] = []
    return snap


def render_text(snap: Dict[str, Any]) -> str:
    lines = [f"== tosem_tpu dashboard @ {time.ctime(snap['timestamp'])}"]
    rtm = snap.get("runtime")
    if rtm:
        lines.append("-- runtime: " + " ".join(
            f"{k}={v}" for k, v in sorted(rtm.items())))
    else:
        lines.append("-- runtime: (not initialized)")
    mem = snap["memory"]
    lines.append(f"-- memory: rss={mem['rss_bytes']/1e6:.1f}MB "
                 f"available={mem['available_bytes']/1e9:.2f}GB")
    if snap["metrics"]:
        lines.append("-- metrics:")
        for m in snap["metrics"]:
            lines.append(f"   {m['series']} = {m['value']:g}")
    if snap["experiments"]:
        lines.append("-- experiments:")
        for e in snap["experiments"]:
            lines.append(f"   {e.get('name', '?'):24s} "
                         f"{e.get('status', '?'):8s} "
                         f"best={e.get('best_score')}")
    if snap.get("deployments"):
        lines.append("-- deployments:")
        for d in snap["deployments"]:
            lines.append(f"   {str(d.get('name')):24s} "
                         f"replicas={d.get('replicas')} "
                         f"load={d.get('load')}")
    if snap["results"]:
        lines.append("-- recent results:")
        for r in snap["results"]:
            val = r.get("value")
            val_s = f"{val:.4g}" if isinstance(val, (int, float)) else "?"
            lines.append(f"   {str(r.get('bench_id')):28s} "
                         f"{str(r.get('metric')):16s} "
                         f"{val_s} {r.get('unit') or ''}")
    return "\n".join(lines)


def _table(rows: List[Dict[str, Any]], cols: List[str],
           table_id: str = "") -> str:
    ident = f' id="{table_id}"' if table_id else ""
    if not rows:
        return (f"<table{ident}><tr></tr></table><p><em>none</em></p>"
                if table_id else "<p><em>none</em></p>")
    head = "".join(f"<th>{html.escape(c)}</th>" for c in cols)
    body = "".join(
        "<tr>" + "".join(f"<td>{html.escape(str(r.get(c, '')))}</td>"
                         for c in cols) + "</tr>"
        for r in rows)
    return f"<table{ident}><tr>{head}</tr>{body}</table>"


def _svg_chart(values: List[float], *, width: int = 360, height: int = 90,
               label: str = "") -> str:
    """Inline SVG line chart (no JS, no external assets — the WebUI's
    default-metric plot rendered server-side)."""
    pts = [(i, v) for i, v in enumerate(values)
           if isinstance(v, (int, float))]
    if len(pts) < 2:
        return ""
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    lo, hi = min(ys), max(ys)
    span = (hi - lo) or 1.0
    pad = 6
    W, H = width - 2 * pad, height - 2 * pad

    def sx(x):
        return pad + W * (x - xs[0]) / max(xs[-1] - xs[0], 1)

    def sy(y):
        return pad + H * (1.0 - (y - lo) / span)

    poly = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in pts)
    dots = "".join(f'<circle cx="{sx(x):.1f}" cy="{sy(y):.1f}" r="2"/>'
                   for x, y in pts)
    return (f'<figure><svg width="{width}" height="{height}" '
            f'viewBox="0 0 {width} {height}">'
            f'<rect width="{width}" height="{height}" fill="#f6f6f6"/>'
            f'<polyline points="{poly}" fill="none" stroke="#369" '
            f'stroke-width="1.5"/>{dots}</svg>'
            f'<figcaption>{html.escape(label)} '
            f'(min {lo:.4g}, max {hi:.4g})</figcaption></figure>')


def _experiment_charts(experiments: List[Dict[str, Any]]) -> str:
    parts = []
    for e in experiments:
        scores = e.get("trial_scores") or []
        chart = _svg_chart(scores,
                           label=f"{e.get('name')}: best score per trial")
        if chart:
            parts.append(chart)
    return "".join(parts)


def _results_charts(results: List[Dict[str, Any]]) -> str:
    series: Dict[str, List[float]] = {}
    for r in results:
        key = f"{r.get('config')}/{r.get('metric')}"
        try:
            series.setdefault(key, []).append(float(r.get("value")))
        except (TypeError, ValueError):
            pass
    return "".join(_svg_chart(vals, label=key)
                   for key, vals in sorted(series.items())
                   if len(vals) >= 2)


def render_html(snap: Dict[str, Any]) -> str:
    rtm = snap.get("runtime") or {}
    rt_rows = [{"key": k, "value": v} for k, v in sorted(rtm.items())]
    mem = snap["memory"]
    return f"""<!doctype html>
<html><head><title>tosem_tpu dashboard</title>
<style>
 body {{ font-family: monospace; margin: 2em; }}
 table {{ border-collapse: collapse; margin: 0.5em 0 1.5em; }}
 th, td {{ border: 1px solid #999; padding: 2px 8px; text-align: left; }}
 h2 {{ margin-bottom: 0.2em; }}
 figure {{ display: inline-block; margin: 0.4em 1em 0.4em 0; }}
 figcaption {{ font-size: 11px; color: #555; }}
</style></head><body>
<h1>tosem_tpu dashboard</h1>
<p>{html.escape(time.ctime(snap['timestamp']))} &mdash;
rss {mem['rss_bytes']/1e6:.1f} MB, available
{mem['available_bytes']/1e9:.2f} GB</p>
<p><button id="pause">pause</button> refresh every
<select id="ival"><option>2</option><option>5</option><option>10</option>
</select>s &mdash; <span id="stamp"></span></p>
<h2>Runtime</h2>{_table(rt_rows, ["key", "value"])}
<h2>Metrics</h2>{_table(snap['metrics'], ["series", "value"],
                        table_id="t-metrics")}
<h2>Experiments <small>(click a row for trials)</small></h2>
{_table(snap['experiments'],
        ["name", "status", "best_score", "n_trials"],
        table_id="t-exp")}
<div id="exp-detail"></div>
{_experiment_charts(snap['experiments'])}
<h2>Deployments</h2>{_table(snap.get('deployments', []),
                            ["name", "replicas", "load"])}
<h2>Recent results <small>(click a header to sort)</small></h2>
{_table(snap['results'],
        ["config", "bench_id", "metric", "value", "unit", "device"],
        table_id="t-results")}
{_results_charts(snap['results'])}
<script>
// live dashboard: poll /api and re-render in place — the interactive
// layer (auto-refresh, pause, sortable results, per-experiment trial
// drill-down) the server-side SVG charts alone did not give
const COLS = {{
  "t-metrics": ["series", "value"],
  "t-exp": ["name", "status", "best_score", "n_trials"],
  "t-results": ["config", "bench_id", "metric", "value", "unit",
                "device"],
}};
let paused = false, sortCol = null, sortDir = -1, lastSnap = null;
// all values land in innerHTML: escape EVERYTHING user-supplied
// (experiment names, bench ids, configs) or the live re-render undoes
// the server-side html.escape
function esc(v) {{
  return String(v ?? "").replace(/[&<>"']/g, (ch) => ({{
    "&": "&amp;", "<": "&lt;", ">": "&gt;",
    '"': "&quot;", "'": "&#39;"}})[ch]);
}}
function fill(id, rows) {{
  const t = document.getElementById(id);
  if (!t || !rows) return;
  const cols = COLS[id];
  let h = "<tr>" + cols.map(c => `<th data-c="${{esc(c)}}">${{esc(c)}}</th>`)
                       .join("") + "</tr>";
  for (const r of rows)
    h += "<tr>" + cols.map(c => `<td>${{esc(r[c])}}</td>`)
                      .join("") + "</tr>";
  t.innerHTML = h;
}}
function renderResults() {{
  let rows = (lastSnap && lastSnap.results) || [];
  if (sortCol !== null) {{
    rows = [...rows].sort((a, b) => {{
      const x = a[sortCol], y = b[sortCol];
      return (typeof x === "number" && typeof y === "number"
              ? x - y : String(x).localeCompare(String(y))) * sortDir;
    }});
  }}
  fill("t-results", rows);
}}
async function tick() {{
  if (paused) return;
  try {{
    lastSnap = await (await fetch("/api")).json();
    fill("t-metrics", lastSnap.metrics);
    fill("t-exp", lastSnap.experiments);
    renderResults();
    document.getElementById("stamp").textContent =
      "live @ " + new Date(lastSnap.timestamp * 1000)
                    .toLocaleTimeString();
  }} catch (e) {{
    document.getElementById("stamp").textContent = "poll failed: " + e;
  }}
}}
document.getElementById("pause").onclick = (e) => {{
  paused = !paused;
  e.target.textContent = paused ? "resume" : "pause";
}};
let timer = setInterval(tick, 2000);
document.getElementById("ival").onchange = (e) => {{
  clearInterval(timer);
  timer = setInterval(tick, Number(e.target.value) * 1000);
}};
document.addEventListener("click", async (ev) => {{
  const th = ev.target.closest("#t-results th");
  if (th) {{
    const c = th.dataset.c;
    // before the first poll the server-rendered <th> has no data-c and
    // lastSnap is null — sorting then would blank the table
    if (!c || !lastSnap) return;
    sortDir = (sortCol === c) ? -sortDir : -1;
    sortCol = c;
    renderResults();
    return;
  }}
  const row = ev.target.closest("#t-exp tr");
  if (row && row.rowIndex > 0) {{
    const name = row.cells[0].textContent;
    const d = await (await fetch(
      "/api/experiment/" + encodeURIComponent(name))).json();
    const div = document.getElementById("exp-detail");
    if (d.error) {{
      div.innerHTML = `<p><em>${{esc(d.error)}}</em></p>`;
      return;
    }}
    let h = `<h3>trials of ${{esc(name)}}</h3><table><tr><th>trial</th>` +
            `<th>status</th><th>score</th><th>config</th></tr>`;
    for (const t of d.trials)
      h += `<tr><td>${{esc(t.trial_id)}}</td><td>${{esc(t.status)}}` +
           `</td><td>${{esc(t.score)}}</td>` +
           `<td>${{esc(JSON.stringify(t.config))}}</td></tr>`;
    div.innerHTML = h + "</table>";
  }}
}});
</script>
</body></html>"""


class DashboardServer:
    """Serves the dashboard over HTTP (shared RouteServer scaffold)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 kv_path: Optional[str] = None,
                 results_csv: Optional[str] = None,
                 serve: Any = None, sysmo: bool = False,
                 driveview: Any = None):
        from tosem_tpu_torch.obs.httpd import RouteServer
        self._sysmo = None
        if sysmo:
            # the checker's gauges land in the global registry, so they
            # appear on the same /metrics + metrics panel as everything
            # else (cpu/rss/threads refreshed each checker tick)
            from tosem_tpu_torch.obs.sysmo import SysMo
            self._sysmo = SysMo(interval_s=1.0,
                                registry=_metrics.DEFAULT).start()
        mgr = None
        if kv_path is not None:
            # one manager (one sqlite connection) for the server's life,
            # not a fresh connect + DDL per request; a bad path degrades
            # to snapshot's per-request error row instead of failing boot
            try:
                from tosem_tpu_torch.tune.experiment import ExperimentManager
                mgr = ExperimentManager(path=kv_path)
            except Exception:
                mgr = None
        kw = {"results_csv": results_csv, "experiments_manager": mgr,
              "kv_path": kv_path if mgr is None else None,
              "serve": serve}

        def route(path: str):
            if path.startswith("/metrics"):
                return (200, "text/plain; version=0.0.4",
                        _metrics.prometheus_text().encode())
            if path.startswith("/api/drive"):
                # dreamview-backend role: the latest scene as JSON
                scene = driveview.scene() if driveview is not None else None
                return (200, "application/json",
                        json.dumps(scene or {}).encode())
            if path.startswith("/drive"):
                from tosem_tpu_torch.obs.driveview import render_scene_svg
                scene = driveview.scene() if driveview is not None else None
                body = ("<!doctype html><html><head>"
                        "<title>drive view</title>"
                        "<meta http-equiv='refresh' content='1'>"
                        "</head><body style='font-family:monospace'>"
                        "<h2>drive view</h2>"
                        + (render_scene_svg(scene) if scene else
                           "<p>(no driveview recorder attached)</p>"
                           if driveview is None else
                           "<p>(no driving frames yet)</p>")
                        + "</body></html>")
                return (200, "text/html", body.encode())
            if path.startswith("/api/experiment/"):
                # trial drill-down for the interactive layer
                from urllib.parse import unquote
                name = unquote(path[len("/api/experiment/"):].split("?")[0])
                if mgr is None:
                    body = {"error": "no experiment store attached"}
                else:
                    try:
                        body = {"name": name, "trials": mgr.results(name)}
                    except Exception as e:
                        body = {"error": repr(e)}
                return (200, "application/json", json.dumps(body).encode())
            if path.startswith("/api"):
                return (200, "application/json",
                        json.dumps(snapshot(**kw)).encode())
            return (200, "text/html", render_html(snapshot(**kw)).encode())

        self._server = RouteServer(route, host, port,
                                   name="tosem-dashboard")
        self.host, self.port = self._server.host, self._server.port

    @property
    def url(self) -> str:
        return self._server.url

    def shutdown(self) -> None:
        if self._sysmo is not None:
            self._sysmo.stop()
        self._server.shutdown()
