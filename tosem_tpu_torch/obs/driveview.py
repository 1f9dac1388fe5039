"""Drive view: the dreamview role on the shared dashboard.

The reference ships a dedicated web HMI rendering the driving world —
lane, obstacles, planned trajectory, vehicle pose — from the module
channels (``modules/dreamview/``: a websocket backend republishing
cyber channels into a JS frontend). Collapsed here: the driving
channels already flow through the deterministic component runtime, so a
tiny recorder component snapshots the latest frame and the dashboard
renders it server-side as inline SVG — no JS, no asset pipeline, same
``obs`` surface as the HPO charts (``obs/dashboard.py``).

Use::

    rec = DriveViewRecorder()
    rtc.add(rec)
    DashboardServer(driveview=rec)   # GET /drive -> SVG scene

A copy of the JAX package's ``obs/driveview.py``: a scene holds host
floats, so the same channel messages render the same bytes. numpy loads
at the first frame, so importing ``obs`` (as the serving routers do)
does not load it.
"""
from __future__ import annotations

import html
import threading
from typing import Any, Dict, List, Optional

from tosem_tpu_torch.dataflow.components import Component

__all__ = ["DriveViewRecorder", "render_scene_svg"]


class DriveViewRecorder(Component):
    """Fuses the driving channels into one latest-frame scene snapshot.

    Primary: ``trajectory`` (one scene per planning cycle); fused:
    predicted obstacles, control command, pose. ``scene()`` is
    thread-safe — the dashboard's HTTP threads read while the runtime
    writes.
    """

    def __init__(self, *, traj_channel: str = "trajectory",
                 pred_channel: str = "predicted_obstacles",
                 control_channel: str = "control",
                 pose_channel: str = "pose",
                 lane_half: float = 1.75, ds: float = 1.0,
                 history: int = 64):
        super().__init__("driveview", [traj_channel, pred_channel,
                                       control_channel, pose_channel])
        self.lane_half, self.ds = lane_half, ds
        self._lock = threading.Lock()
        self._scene: Optional[Dict[str, Any]] = None
        self._speed_hist: List[float] = []
        # history=0 would make the del-slice below a no-op and the list
        # unbounded on long runs
        self._history = max(int(history), 1)

    def proc(self, traj, pred=None, control=None, pose=None) -> None:
        import numpy as np       # routers import obs without numpy
        scene: Dict[str, Any] = {
            "lane_half": self.lane_half,
            "ds": self.ds,
            "path_l": [float(v) for v in np.asarray(traj["path_l"])],
            "s_profile": [float(v)
                          for v in np.asarray(traj["s_profile"])],
            "stop_fence": traj.get("stop_fence"),
            "scenario": traj.get("scenario"),
            "v_ref": traj.get("v_ref"),
        }
        if pred is not None:
            scene["obstacles"] = np.asarray(
                pred["obstacles"], np.float64).reshape(-1, 4).tolist()
        if control is not None:
            scene["steer0"] = float(np.asarray(control["steer"]).ravel()[0])
            scene["accel0"] = float(np.asarray(control["accel"]).ravel()[0])
        if pose is not None:
            scene["ego"] = {"pos": [float(p) for p in pose["pos"]],
                            "yaw": float(pose["yaw"]),
                            "v": float(pose["v"])}
            with self._lock:
                self._speed_hist.append(float(pose["v"]))
                del self._speed_hist[:-self._history]
        with self._lock:
            scene["speed_history"] = list(self._speed_hist)
            self._scene = scene

    def scene(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self._scene) if self._scene else None


def _sx(s: float, ds: float, n: int, width: float) -> float:
    return 30.0 + (width - 40.0) * s / max(n * ds, 1e-9)


def _sy(l: float, lane_half: float, height: float) -> float:
    half = height / 2.0
    return half - l * (half - 12.0) / max(2.0 * lane_half, 1e-9)


def render_scene_svg(scene: Dict[str, Any], *, width: int = 720,
                     height: int = 220) -> str:
    """Top-down station/lateral scene as inline SVG (pure, no JS).

    Geometry is the planner's own frame: x = station s (ego at s=0,
    driving right), y = lateral l. Obstacles draw as swept-corridor
    rectangles exactly as the planner sees them — the view can never
    disagree with the optimizer about where a blocker is, which is the
    whole point of rendering from the channels rather than a parallel
    world model (dreamview's backend does the same from cyber channels).
    """
    if not scene:
        return "<p>(no driving frames yet)</p>"
    lane_half = float(scene.get("lane_half", 1.75))
    ds = float(scene.get("ds", 1.0))
    path = scene.get("path_l") or []
    n = max(len(path), 2)
    parts = [f'<svg width="{width}" height="{height}" '
             f'viewBox="0 0 {width} {height}" role="img">',
             f'<rect width="{width}" height="{height}" fill="#f2f4f0"/>']
    # lane band + centerline + edges
    top = _sy(lane_half, lane_half, height)
    bot = _sy(-lane_half, lane_half, height)
    parts.append(f'<rect x="20" y="{top:.1f}" width="{width - 30}" '
                 f'height="{bot - top:.1f}" fill="#dfe8df"/>')
    mid = _sy(0.0, lane_half, height)
    parts.append(f'<line x1="20" y1="{mid:.1f}" x2="{width - 10}" '
                 f'y2="{mid:.1f}" stroke="#aaa" stroke-dasharray="8,6"/>')
    for yy in (top, bot):
        parts.append(f'<line x1="20" y1="{yy:.1f}" x2="{width - 10}" '
                     f'y2="{yy:.1f}" stroke="#667" stroke-width="2"/>')
    # swept obstacle corridors (inert padding rows have s0 > s1)
    for s0, s1, l0, l1 in scene.get("obstacles") or []:
        if s1 <= s0:
            continue
        x0, x1 = _sx(s0, ds, n, width), _sx(s1, ds, n, width)
        y1v, y0v = _sy(l0, lane_half, height), _sy(l1, lane_half, height)
        parts.append(f'<rect x="{x0:.1f}" y="{y0v:.1f}" '
                     f'width="{max(x1 - x0, 2):.1f}" '
                     f'height="{max(y1v - y0v, 2):.1f}" fill="#c66" '
                     f'fill-opacity="0.55" stroke="#a33"/>')
    # stop fence
    fence = scene.get("stop_fence")
    if isinstance(fence, (int, float)) and fence < n * ds:
        xf = _sx(float(fence), ds, n, width)
        parts.append(f'<line x1="{xf:.1f}" y1="{top:.1f}" x2="{xf:.1f}" '
                     f'y2="{bot:.1f}" stroke="#c00" stroke-width="3" '
                     f'stroke-dasharray="4,4"/>')
    # planned path
    if len(path) >= 2:
        pts = " ".join(
            f"{_sx(i * ds, ds, n, width):.1f},"
            f"{_sy(float(l), lane_half, height):.1f}"
            for i, l in enumerate(path))
        parts.append(f'<polyline points="{pts}" fill="none" '
                     f'stroke="#269" stroke-width="2.5"/>')
    # ego marker (triangle at s=0 on the path start)
    y_ego = _sy(float(path[0]) if path else 0.0, lane_half, height)
    x_ego = _sx(0.0, ds, n, width)
    parts.append(f'<polygon points="{x_ego - 6:.1f},{y_ego - 6:.1f} '
                 f'{x_ego - 6:.1f},{y_ego + 6:.1f} '
                 f'{x_ego + 8:.1f},{y_ego:.1f}" fill="#164"/>')
    parts.append("</svg>")
    # caption: scenario + command summary, all escaped
    bits = []
    if scene.get("scenario"):
        bits.append(f"scenario {scene['scenario']}")
    if scene.get("v_ref") is not None:
        bits.append(f"v_ref {float(scene['v_ref']):.1f} m/s")
    ego = scene.get("ego")
    if ego:
        bits.append(f"ego v {ego['v']:.1f} m/s")
    if scene.get("steer0") is not None:
        bits.append(f"steer {scene['steer0']:+.3f} rad")
    if scene.get("accel0") is not None:
        bits.append(f"accel {scene['accel0']:+.2f} m/s²")
    caption = html.escape(" · ".join(bits)) or "driving frame"
    figure = (f"<figure>{''.join(parts)}"
              f"<figcaption>{caption}</figcaption></figure>")
    hist = scene.get("speed_history") or []
    if len(hist) >= 2:
        from tosem_tpu_torch.obs.dashboard import _svg_chart
        figure += _svg_chart(hist, label="ego speed (m/s)")
    return figure
