"""The driving stack end to end on the port: record/replay determinism
(``tests/test_driving_replay.py``), the drive view
(``tests/test_driveview.py``) and the quickstart's drive against the JAX
package.

Copies of ``test_driving_replay.py``'s test (a drive recorded and
replayed renders a byte-identical scene) and ``test_driveview.py``'s
seven (scene recording, SVG, the dashboard's ``/drive`` and
``/api/drive`` routes on a server bound to port 0 and shut down in
``finally``) against the port on the CPU. Across packages:
``examples/quickstart_driving.py``'s drive (route, tracker, the driving
pipeline with localization, the drive view) through both: the same
route, scenario trace, candidates and stop fences, and paths, speed
profiles, commands and poses within ``DRIVE_TOL`` (``drive_gaps``).
"""
import json
import urllib.request

import numpy as np
import torch

from tosem_tpu_torch.cluster.replay import Recorder, replay
from tosem_tpu_torch.dataflow.components import ComponentRuntime
from tosem_tpu_torch.models.control import (build_driving_pipeline,
                                            drive_gaps)
from tosem_tpu_torch.models.perception import TrackerComponent
from tosem_tpu_torch.obs.dashboard import DashboardServer
from tosem_tpu_torch.obs.driveview import DriveViewRecorder, render_scene_svg

torch.set_num_threads(1)
CPU = "cpu"

INPUTS = ("detections", "imu", "gnss", "ego")


def _drive(inputs):
    """Run the full stack over (t, channel, msg) inputs; return the
    final rendered scene + per-frame trajectory fingerprints."""
    rtc = ComponentRuntime()
    rtc.add(TrackerComponent(iou_threshold=0.1))
    build_driving_pipeline(rtc, frame_dt=1.0, horizon=2.0, localize=True,
                           device=CPU)
    view = DriveViewRecorder()
    rtc.add(view)
    writers = {ch: rtc.writer(ch) for ch in INPUTS}
    fingerprints = []
    view_scene = {}
    last_t = 0.0
    for t, ch, msg in inputs:
        if t > last_t:
            rtc.run_until(t)
            last_t = t
        writers[ch](msg)
    rtc.run_until(last_t + 1.0)
    scene = view.scene()
    return render_scene_svg(scene), scene


def _scripted_inputs():
    rng = np.random.default_rng(7)
    out = []
    for i in range(12):
        t = float(i + 1)
        x0 = 30.0 - 1.5 * i
        out.append((t, "detections",
                    {"boxes": np.array([[x0, -0.4, x0 + 3.0, 0.6]]),
                     "scores": np.array([0.9])}))
        out.append((t, "ego", {"v": 8.0}))
        out.append((t, "imu", {"yaw_rate": float(rng.normal(0, 0.02)),
                               "accel": float(rng.normal(0, 0.1))}))
        if i % 3 == 0:
            out.append((t, "gnss", {"pos": [8.0 * i, 0.0]}))
    return out


def test_replayed_drive_renders_identical_scene(tmp_path):
    inputs = _scripted_inputs()

    # leg 1: live run, recording the raw input channels as we feed them
    rec = Recorder(str(tmp_path / "drive.rec"))
    for t, ch, msg in inputs:
        rec.write(ch, {"t": t, **{k: (v.tolist()
                                      if isinstance(v, np.ndarray) else v)
                                  for k, v in msg.items()}})
    rec.close()
    svg_live, scene_live = _drive(inputs)

    # leg 2: rebuild the input stream FROM the recording only
    replayed = []
    for topic, _wall_t, msg in replay(str(tmp_path / "drive.rec")):
        t = msg.pop("t")
        msg = {k: (np.asarray(v) if isinstance(v, list) else v)
               for k, v in msg.items()}
        replayed.append((t, topic, msg))
    replayed.sort(key=lambda r: r[0])
    svg_replay, scene_replay = _drive(replayed)

    assert scene_live["path_l"] == scene_replay["path_l"]
    assert scene_live["scenario"] == scene_replay["scenario"]
    assert scene_live["ego"] == scene_replay["ego"]
    # the whole rendered artifact reproduces byte-for-byte
    assert svg_live == svg_replay


def _drive_frames(rec=None, frames=3):
    rtc = ComponentRuntime()
    rtc.add(TrackerComponent(iou_threshold=0.1))
    build_driving_pipeline(rtc, frame_dt=1.0, horizon=2.0, localize=True,
                           device=CPU)
    if rec is not None:
        rtc.add(rec)
    det_w = rtc.writer("detections")
    imu_w = rtc.writer("imu")
    gnss_w = rtc.writer("gnss")
    for i in range(frames):
        det_w({"boxes": np.array([[18.0, -0.6, 22.0, 0.5]]),
               "scores": np.array([0.9])})
        gnss_w({"pos": [1.0 * i, 0.0]})
        imu_w({"yaw_rate": 0.0, "accel": 0.0})
        rtc.run_until(float(i + 1))
    return rtc


class TestRecorder:
    def test_scene_fuses_all_channels(self):
        rec = DriveViewRecorder(lane_half=1.75)
        _drive_frames(rec)
        scene = rec.scene()
        assert scene is not None
        assert len(scene["path_l"]) >= 2
        obs = np.asarray(scene["obstacles"])
        live = obs[obs[:, 1] > obs[:, 0]]
        assert len(live) >= 1 and live[0, 0] <= 18.0
        assert "steer0" in scene and "accel0" in scene
        assert scene["ego"]["v"] > 0
        assert len(scene["speed_history"]) >= 1

    def test_empty_scene_before_any_frame(self):
        assert DriveViewRecorder().scene() is None


class TestRender:
    def test_svg_contains_scene_elements(self):
        rec = DriveViewRecorder()
        _drive_frames(rec)
        svg = render_scene_svg(rec.scene())
        assert "<svg" in svg and "polyline" in svg      # planned path
        assert "polygon" in svg                          # ego marker
        assert svg.count("<rect") >= 3                   # bg+lane+obstacle
        assert "figcaption" in svg

    def test_render_handles_missing_fields(self):
        assert "no driving frames" in render_scene_svg({})
        minimal = {"path_l": [0.0, 0.1], "s_profile": [0.0, 1.0]}
        out = render_scene_svg(minimal)
        assert "<svg" in out

    def test_caption_escapes_hostile_scenario_name(self):
        scene = {"path_l": [0.0, 0.1], "s_profile": [0.0, 1.0],
                 "scenario": "<script>alert(1)</script>"}
        out = render_scene_svg(scene)
        assert "<script>" not in out


class TestHttp:
    def test_drive_routes(self):
        rec = DriveViewRecorder()
        _drive_frames(rec)
        srv = DashboardServer(driveview=rec)
        try:
            page = urllib.request.urlopen(
                srv.url + "/drive", timeout=10).read().decode()
            assert "<svg" in page and "drive view" in page
            api = json.loads(urllib.request.urlopen(
                srv.url + "/api/drive", timeout=10).read().decode())
            assert api["path_l"] == rec.scene()["path_l"]
        finally:
            srv.shutdown()

    def test_drive_route_without_recorder(self):
        srv = DashboardServer()
        try:
            page = urllib.request.urlopen(
                srv.url + "/drive", timeout=10).read().decode()
            assert "no driveview recorder" in page
        finally:
            srv.shutdown()


# ------------------------------------------------- against the JAX package

def quickstart_drive(package):
    """``examples/quickstart_driving.py``'s drive through ``package``:
    the route, then seven frames (clear road, a car drifting into the
    lane, a full-lane wall). Returns the route message, the frames
    (trajectory, control and pose messages) and the final scene's SVG."""
    if package == "jax":
        from tosem_tpu.dataflow.components import Component, ComponentRuntime
        from tosem_tpu.models import (Lane, LaneGraph, RoutingComponent,
                                      TrackerComponent,
                                      build_driving_pipeline)
        from tosem_tpu.obs.driveview import (DriveViewRecorder,
                                             render_scene_svg)
        kw = {}
    else:
        from tosem_tpu_torch.dataflow.components import (Component,
                                                         ComponentRuntime)
        from tosem_tpu_torch.models import (Lane, LaneGraph,
                                            RoutingComponent,
                                            TrackerComponent,
                                            build_driving_pipeline)
        from tosem_tpu_torch.obs.driveview import (DriveViewRecorder,
                                                   render_scene_svg)
        kw = {"device": CPU}
    graph = LaneGraph([
        Lane("on_ramp", 120.0, successors=["highway_a"]),
        Lane("highway_a", 400.0, successors=["highway_b"]),
        Lane("highway_b", 400.0, successors=[], half_width=1.6),
    ])
    rtc = ComponentRuntime()
    rtc.add(RoutingComponent(graph))
    rtc.add(TrackerComponent(iou_threshold=0.1))
    build_driving_pipeline(rtc, lane_half=1.6, frame_dt=1.0, horizon=2.0,
                           localize=True, **kw)
    view = DriveViewRecorder(lane_half=1.6)
    rtc.add(view)
    frames, routes = [], []

    class Monitor(Component):
        def __init__(self):
            super().__init__("monitor", ["trajectory", "route", "control",
                                         "pose"])

        def proc(self, traj, route, ctl, pose):
            routes.append(route)
            frames.append({"trajectory": traj, "control": ctl,
                           "pose": pose})

    rtc.add(Monitor())
    rtc.writer("route_request")({"src": "on_ramp", "dst": "highway_b"})
    rtc.run_until(0.5)
    det_w, ego_w = rtc.writer("detections"), rtc.writer("ego")
    imu_w, gnss_w = rtc.writer("imu"), rtc.writer("gnss")
    scenes = ([[]] * 2
              + [[[38.0, 1.4 - 0.4 * i, 42.0, 2.4 - 0.4 * i]]
                 for i in range(3)]
              + [[[12.0, -1.6, 16.0, 1.6]]] * 2)
    t = 0.5
    for i, boxes in enumerate(scenes):
        ego_w({"v": 8.0})
        gnss_w({"pos": [8.0 * i, 0.0]})
        imu_w({"yaw_rate": 0.0, "accel": 0.0})
        det_w({"boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
               "scores": np.ones((len(boxes),), np.float32)})
        t += 1.0
        rtc.run_until(t)
    return routes[-1], frames, render_scene_svg(view.scene())


def test_quickstart_drive_matches_the_jax_package():
    route, frames, svg = quickstart_drive("torch")
    want_route, want, _ = quickstart_drive("jax")
    # the quickstart's own assertions, on the port
    assert route["route"] == ["on_ramp", "highway_a", "highway_b"]
    scenarios = [f["trajectory"]["scenario"] for f in frames]
    assert scenarios[0] == "LANE_FOLLOW" and "EMERGENCY_STOP" in scenarios
    assert frames[-1]["trajectory"]["stop_fence"] <= 11.0
    assert "<svg" in svg and "polyline" in svg
    # and against the JAX package, frame by frame
    assert route == want_route
    assert len(frames) == len(want) == 7
    parted, worst = drive_gaps(frames, want)
    assert parted == []
    assert max(worst.values()) <= 1.0, worst
