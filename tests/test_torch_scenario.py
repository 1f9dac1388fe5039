"""Scenario-lite (``models/scenario.py``): per-cycle scenario selection
with asymmetric hysteresis parameterizing the planning tasks, held to
the JAX package's own tests and to the JAX package.

Copies of ``tests/test_scenario.py``'s nine tests against the port on
the CPU, its 100-frame soak included: the soak runs once in a module
fixture (about 15 s on one thread) and, unlike the JAX package's, it is
not ``slow``, since its frames are also the cross-package check: the
same randomized traffic through the JAX package's stack gives the same
scenario trace and stop fences frame by frame, the same candidates, and
paths, speed profiles, commands and poses within ``DRIVE_TOL``
(``drive_gaps``).
"""
import numpy as np
import pytest
import torch

from tosem_tpu_torch.dataflow.components import Component, ComponentRuntime
from tosem_tpu_torch.models.control import (PlanningComponent, drive_gaps)
from tosem_tpu_torch.models.prediction import PredictionComponent
from tosem_tpu_torch.models.scenario import (EMERGENCY_STOP, LANE_FOLLOW,
                                             OBSTACLE_AVOID,
                                             ScenarioComponent,
                                             ScenarioManager)

torch.set_num_threads(1)
CPU = "cpu"

PAD = [-1.0, -2.0, 0.0, 0.0]


class TestManagerRules:
    def test_clear_road_is_lane_follow(self):
        m = ScenarioManager()
        assert m.select([PAD, PAD], ego_v=8.0) == LANE_FOLLOW
        assert m.params().v_ref == m.cruise_v

    def test_passable_obstacle_is_avoid(self):
        m = ScenarioManager()
        # obstacle leaves the whole left half-lane free
        assert m.select([[20.0, 24.0, -1.75, 0.0], PAD], 8.0) \
            == OBSTACLE_AVOID
        assert m.params().v_ref == m.avoid_v

    def test_full_lane_blocker_inside_braking_distance_is_emergency(self):
        m = ScenarioManager(a_brake=3.0, margin_m=5.0)
        blocker = [[12.0, 16.0, -1.75, 1.75], PAD]
        # 8 m/s: brake distance 64/6 + 5 ≈ 15.7 > s0=12 → emergency
        assert m.select(blocker, ego_v=8.0) == EMERGENCY_STOP
        p = m.params()
        assert p.v_ref == 0.0 and p.hard_fence

    def test_far_blocker_is_avoid_not_emergency(self):
        m = ScenarioManager()
        assert m.select([[60.0, 64.0, -1.75, 1.75], PAD], 8.0) \
            == OBSTACLE_AVOID

    def test_escalation_immediate_deescalation_dwells(self):
        m = ScenarioManager(min_dwell=3)
        blocker = [[10.0, 14.0, -1.75, 1.75], PAD]
        assert m.select([PAD], 8.0) == LANE_FOLLOW
        # escalate instantly
        assert m.select(blocker, 8.0) == EMERGENCY_STOP
        # road clears: stays emergency for min_dwell cycles
        assert m.select([PAD], 8.0) == EMERGENCY_STOP
        assert m.select([PAD], 8.0) == EMERGENCY_STOP
        assert m.select([PAD], 8.0) == LANE_FOLLOW   # 3rd calm cycle
        # an interrupted dwell resets
        assert m.select(blocker, 8.0) == EMERGENCY_STOP
        assert m.select([PAD], 8.0) == EMERGENCY_STOP
        assert m.select(blocker, 8.0) == EMERGENCY_STOP
        assert m.select([PAD], 8.0) == EMERGENCY_STOP


class TestScenarioInPipeline:
    def test_emergency_stops_the_speed_profile(self):
        """prediction → scenario → planning: a close full-lane blocker
        flips the scenario and the planned profile stops short of it."""
        rtc = ComponentRuntime()
        rtc.add(PredictionComponent(frame_dt=1.0, horizon=1.0, dt=0.5,
                                    max_k=2))
        rtc.add(ScenarioComponent())
        rtc.add(PlanningComponent(in_channel="planning_request",
                                  n=64, ds=1.0, v_init=8.0, device=CPU))
        out = []

        class Sink(Component):
            def __init__(self):
                super().__init__("sink", ["trajectory"])

            def proc(self, traj, *f):
                out.append(traj)

        rtc.add(Sink())
        ego_w = rtc.writer("ego")
        tracks_w = rtc.writer("tracks")
        ego_w({"v": 8.0})
        # static wall dead ahead spanning the lane, 14 m out
        tracks_w([{"track_id": 1, "box": [14.0, -1.75, 18.0, 1.75]}])
        rtc.run_until(1.0)
        assert len(out) == 1
        traj = out[0]
        assert traj["scenario"] == EMERGENCY_STOP
        assert traj["v_ref"] == 0.0
        assert traj["stop_fence"] <= 13.0
        assert traj["s_profile"].max() <= traj["stop_fence"] + 0.5

    def test_factory_shares_one_geometry(self):
        """build_driving_pipeline: one lane_half / pass-gap reaches the
        scenario rules AND the planner fence, and prediction fields
        (velocities) survive the scenario pass-through."""
        from tosem_tpu_torch.models.control import build_driving_pipeline

        rtc = ComponentRuntime()
        pred, scen, plan, ctl = build_driving_pipeline(
            rtc, lane_half=2.5, min_pass_gap=0.6, frame_dt=1.0,
            horizon=1.0, device=CPU)
        assert scen.manager.lane_half == plan.lane_half == 2.5
        assert scen.manager.min_pass_gap == plan.MIN_PASS_GAP == 0.6
        got = []

        class Sink(Component):
            def __init__(self):
                super().__init__("sink", ["planning_request"])

            def proc(self, req, *f):
                got.append(req)

        rtc.add(Sink())
        rtc.writer("ego")({"v": 8.0})
        rtc.writer("tracks")(
            [{"track_id": 1, "box": [30.0, -0.5, 34.0, 0.5]}])
        rtc.run_until(1.0)
        assert "velocities" in got[0]        # pass-through preserved
        assert got[0]["scenario"] == OBSTACLE_AVOID

    def test_clear_road_cruises(self):
        rtc = ComponentRuntime()
        rtc.add(PredictionComponent(frame_dt=1.0, max_k=2))
        rtc.add(ScenarioComponent())
        rtc.add(PlanningComponent(in_channel="planning_request",
                                  n=64, ds=1.0, v_init=8.0, device=CPU))
        out = []

        class Sink(Component):
            def __init__(self):
                super().__init__("sink", ["trajectory"])

            def proc(self, traj, *f):
                out.append(traj)

        rtc.add(Sink())
        rtc.writer("ego")({"v": 8.0})
        rtc.writer("tracks")([])
        rtc.run_until(1.0)
        traj = out[0]
        assert traj["scenario"] == LANE_FOLLOW
        assert traj["v_ref"] == pytest.approx(8.0)
        # profile actually advances at cruise speed
        assert traj["s_profile"].max() > 40.0


def _soak(package):
    """100 frames of randomized traffic through ``package``'s prediction
    → scenario → planning → control loop with localization and a drive
    view (``tests/test_scenario.py``'s soak). Returns the frames (dicts
    of the control, trajectory and pose messages) and the last scene's
    SVG."""
    if package == "jax":
        from tosem_tpu.dataflow.components import Component as Comp
        from tosem_tpu.dataflow.components import ComponentRuntime as Rt
        from tosem_tpu.models.control import build_driving_pipeline
        from tosem_tpu.obs.driveview import (DriveViewRecorder,
                                             render_scene_svg)
        kw = {}
    else:
        Comp, Rt = Component, ComponentRuntime
        from tosem_tpu_torch.models.control import build_driving_pipeline
        from tosem_tpu_torch.obs.driveview import (DriveViewRecorder,
                                                   render_scene_svg)
        kw = {"device": CPU}
    rng = np.random.default_rng(3)
    rtc = Rt()
    build_driving_pipeline(rtc, frame_dt=1.0, horizon=2.0,
                           n=32, max_k=2, localize=True, **kw)
    view = DriveViewRecorder()
    rtc.add(view)
    frames = []

    class Sink(Comp):
        def __init__(self):
            super().__init__("sink", ["control", "trajectory",
                                      "pose"])

        def proc(self, ctl, traj, pose):
            frames.append({"control": ctl, "trajectory": traj,
                           "pose": pose})

    rtc.add(Sink())
    ego_w, det_w = rtc.writer("ego"), rtc.writer("tracks")
    imu_w, gnss_w = rtc.writer("imu"), rtc.writer("gnss")
    t = 0.0
    for i in range(100):
        k = int(rng.integers(0, 3))
        tracks = []
        for j in range(k):
            x0 = float(rng.uniform(-10.0, 30.0))
            y0 = float(rng.uniform(-2.5, 2.0))
            tracks.append({"track_id": int(rng.integers(0, 5)),
                           "box": [x0, y0, x0 + rng.uniform(1, 6),
                                   y0 + rng.uniform(0.3, 1.2)]})
        ego_w({"v": float(rng.uniform(2.0, 12.0))})
        det_w(tracks)
        # noisy localization inputs alongside the traffic
        if i % 4 == 0:
            gnss_w({"pos": [5.0 * i + rng.normal(0, 0.5),
                            rng.normal(0, 0.5)]})
        imu_w({"yaw_rate": float(rng.normal(0, 0.05)),
               "accel": float(rng.normal(0, 0.3))})
        t += 1.0
        rtc.run_until(t)
    return frames, render_scene_svg(view.scene())


@pytest.fixture(scope="module")
def soak_frames():
    return _soak("torch")


class TestDrivingSoak:
    def test_hundred_frame_randomized_soak(self, soak_frames):
        """Stability: 100 frames of randomized traffic through the full
        prediction → scenario → planning → control loop — every frame's
        plan and commands stay finite, scenario stays in-vocabulary, and
        the loop never wedges (the long-running-pipeline property the
        reference's road tests assert in hours, compressed to seconds)."""
        frames, svg = soak_frames
        assert len(frames) == 100
        seen = set()
        for f in frames:
            ctl, traj, pose = f["control"], f["trajectory"], f["pose"]
            seen.add(traj["scenario"])
            assert traj["scenario"] in (LANE_FOLLOW, OBSTACLE_AVOID,
                                        EMERGENCY_STOP)
            assert np.isfinite(traj["path_l"]).all()
            assert np.isfinite(traj["s_profile"]).all()
            assert np.isfinite(ctl["steer"]).all()
            assert np.isfinite(ctl["accel"]).all()
            # the EKF pose never goes non-finite under noisy inputs
            assert np.isfinite(pose["pos"]).all()
            assert np.isfinite(pose["cov"]).all()
        # randomized traffic must actually exercise multiple scenarios
        assert len(seen) >= 2, seen
        # the dreamview recorder kept pace with the loop and its last
        # scene renders (the long-running-HMI property)
        assert "<svg" in svg


def test_soak_matches_the_jax_package(soak_frames):
    """The soak's frames through the JAX package: the scenario trace
    and fences equal, every other output by ``drive_gaps``."""
    frames, _ = soak_frames
    want, _ = _soak("jax")
    assert [f["trajectory"]["scenario"] for f in frames] == \
        [f["trajectory"]["scenario"] for f in want]
    assert [f["trajectory"]["stop_fence"] for f in frames] == \
        [f["trajectory"]["stop_fence"] for f in want]
    parted, worst = drive_gaps(frames, want)
    assert parted == []
    assert max(worst.values()) <= 1.0, worst
