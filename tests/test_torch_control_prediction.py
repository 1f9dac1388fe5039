"""Prediction-lite + control-lite (``models/prediction.py``,
``models/control.py``), held to the JAX package's own tests and to the
JAX package.

Copies of ``tests/test_control_prediction.py``'s ten tests against the
port on the CPU (``vmap``'s candidate batch is the rollout's leading
axis). Across packages: the speed-scheduled LQR gain and the
closed-loop rollouts (single and a candidate batch) on the same inputs
within ``CTL_TOL`` of the largest value (the 1 x 1 Riccati system is a
division here, an LU solve in XLA; measured gaps 5e-6 and below), and
prediction's rows (host numpy in both packages) equal.
"""
import numpy as np
import pytest
import torch

from tosem_tpu_torch.dataflow.components import Component, ComponentRuntime
from tosem_tpu_torch.models.control import (ControlComponent,
                                            PlanningComponent,
                                            VehicleParams, bicycle_matrices,
                                            discretize, lateral_gain,
                                            lqr_gain, track_candidates,
                                            track_trajectory)
from tosem_tpu_torch.models.perception import TrackerComponent
from tosem_tpu_torch.models.prediction import (PredictionComponent,
                                               TrackVelocityEstimator,
                                               predict_rollout,
                                               swept_obstacles)

torch.set_num_threads(1)
CPU = "cpu"
CTL_TOL = 1e-5


class TestPrediction:
    def test_constant_velocity_rollout(self):
        boxes = np.array([[0.0, 0.0, 2.0, 1.0]])
        vels = np.array([[2.0, 0.0]])
        roll = predict_rollout(boxes, vels, horizon=2.0, dt=1.0)
        assert roll.shape == (1, 2, 4)
        np.testing.assert_allclose(roll[0, 0], [2.0, 0.0, 4.0, 1.0])
        np.testing.assert_allclose(roll[0, 1], [4.0, 0.0, 6.0, 1.0])

    def test_swept_corridor_covers_motion(self):
        boxes = np.array([[10.0, -0.5, 12.0, 0.5]])
        vels = np.array([[4.0, 0.0]])       # moving ahead at 4 m/s
        obs = swept_obstacles(boxes, vels, horizon=5.0, dt=1.0, max_k=3)
        assert obs.shape == (3, 4)
        s0, s1, l0, l1 = obs[0]
        assert s0 == pytest.approx(10.0)
        assert s1 == pytest.approx(12.0 + 4.0 * 5.0)
        assert l0 == pytest.approx(-0.5) and l1 == pytest.approx(0.5)
        # remaining rows are inert padding (s0 > s1)
        assert (obs[1:, 0] > obs[1:, 1]).all()

    def test_behind_and_offlane_obstacles_dropped(self):
        boxes = np.array([[-20.0, 0.0, -10.0, 1.0],    # behind ego
                          [5.0, 8.0, 7.0, 9.0]])       # far off-lane
        vels = np.zeros((2, 2))
        obs = swept_obstacles(boxes, vels, horizon=1.0, dt=1.0,
                              lane_half=1.75, max_k=2)
        assert (obs[:, 0] > obs[:, 1]).all()   # all padding

    def test_velocity_estimator_finite_difference(self):
        est = TrackVelocityEstimator(dt=0.5)
        t0 = [{"track_id": 1, "box": [0.0, 0.0, 2.0, 1.0]}]
        t1 = [{"track_id": 1, "box": [1.0, 0.0, 3.0, 1.0]},
              {"track_id": 2, "box": [5.0, 5.0, 6.0, 6.0]}]
        v0 = est.update(t0)
        np.testing.assert_allclose(v0, [[0.0, 0.0]])   # first sight
        v1 = est.update(t1)
        np.testing.assert_allclose(v1[0], [2.0, 0.0])  # 1m / 0.5s
        np.testing.assert_allclose(v1[1], [0.0, 0.0])  # new track


class TestLqr:
    def test_closed_loop_stable_open_loop_not(self):
        """The synthesized gain must place every closed-loop eigenvalue
        inside the unit circle (the property the reference's Riccati
        iteration converges to)."""
        p = VehicleParams()
        a, b = bicycle_matrices(p, torch.tensor(10.0))
        ad, bd = discretize(a, b, 0.1)
        k = lateral_gain(p, torch.tensor(10.0), dt=0.1)
        acl = (ad - bd @ k).numpy()
        assert np.abs(np.linalg.eigvals(acl)).max() < 1.0

    def test_riccati_fixed_point(self):
        """K is the fixed point of the Riccati recursion: re-running the
        synthesis with more iterations must not move the gain."""
        p = VehicleParams()
        a, b = bicycle_matrices(p, torch.tensor(15.0))
        ad, bd = discretize(a, b, 0.1)
        q = torch.diag(torch.tensor([1.0, 0.0, 1.0, 0.0]))
        r = torch.tensor([[10.0]])
        k100 = lqr_gain(ad, bd, q, r, n_iter=100)
        k300 = lqr_gain(ad, bd, q, r, n_iter=300)
        np.testing.assert_allclose(k100.numpy(), k300.numpy(), atol=1e-4)

    def test_offset_start_converges(self):
        n, dt, nt = 64, 0.25, 40
        path = torch.zeros(n)
        sprof = torch.arange(nt, dtype=torch.float32) * 8.0 * dt
        roll = track_trajectory(path, sprof, ds=1.0, dt=dt, n_steps=nt,
                                init=(0.0, 1.0, 0.0, 8.0))
        e = roll["e_lat"].numpy()
        assert abs(e[0]) > 0.9          # starts a meter off the path
        assert abs(e[-1]) < 0.15        # LQR pulls it back
        assert float(roll["max_e_station"]) < 2.0

    def test_candidate_batch_scores_match_single(self):
        """vmap-batched controller-in-the-loop scoring equals the
        per-candidate rollout — batching never changes semantics."""
        n, dt, nt = 32, 0.25, 20
        sprof = torch.arange(nt, dtype=torch.float32) * 8.0 * dt
        paths = torch.stack([torch.zeros(n), torch.full((n,), 0.5)])
        batch = track_candidates(paths, sprof, ds=1.0, dt=dt, n_steps=nt)
        single = track_trajectory(paths[1], sprof, ds=1.0, dt=dt,
                                  n_steps=nt)
        np.testing.assert_allclose(batch["e_lat"][1].numpy(),
                                   single["e_lat"].numpy(), atol=1e-5)


class TestStopFence:
    def test_full_lane_blocker_forces_stop(self):
        """An obstacle spanning the whole lane band cannot be passed on
        either side — the speed planner must stop the ego short of it
        (the reference's stop-decision in the speed-bounds decider)."""
        comp = PlanningComponent(n=64, ds=1.0, v_init=8.0, device=CPU)
        blocker = np.array([[25.0, 30.0, -1.75, 1.75],
                            [-1.0, -2.0, 0.0, 0.0],
                            [-1.0, -2.0, 0.0, 0.0]], np.float32)
        assert comp._stop_fence(blocker) == pytest.approx(24.0)
        out = {}
        comp._write = out.update
        comp.proc({"obstacles": blocker})
        assert out["stop_fence"] == pytest.approx(24.0)
        sprof = out["s_profile"]
        assert sprof.max() <= 24.0 + 0.5      # stops at the fence
        # a passable obstacle leaves the fence at the horizon end
        passable = np.array([[25.0, 30.0, -1.75, 0.5]], np.float32)
        assert comp._stop_fence(passable) == pytest.approx(63.0)


class TestDrivingPipeline:
    def test_perception_to_control_loop(self):
        """detections → tracker → prediction → planning → control on the
        deterministic runtime: the planned path dodges the predicted
        corridor and the controller tracks it within bounds."""
        rtc = ComponentRuntime()
        rtc.add(TrackerComponent(iou_threshold=0.1))
        rtc.add(PredictionComponent(frame_dt=1.0, horizon=2.0, dt=0.5,
                                    max_k=2))
        rtc.add(PlanningComponent(n=64, ds=1.0, v_init=8.0, device=CPU))
        rtc.add(ControlComponent(n_steps=40, device=CPU))
        out: list = []

        class Sink(Component):
            def __init__(self):
                super().__init__("sink", ["control", "trajectory",
                                          "predicted_obstacles"])

            def proc(self, ctl, traj, pred):
                out.append((ctl, traj, pred))

        rtc.add(Sink())
        det_w = rtc.writer("detections")
        # a static box dead ahead in-lane, drifting slowly left
        for i, cy in enumerate((-0.6, -0.5, -0.4)):
            det_w({"boxes": np.array([[20.0, cy, 24.0, cy + 1.0]]),
                   "scores": np.array([0.9])})
            rtc.run_until(float(i + 1))

        assert len(out) == 3
        ctl, traj, pred = out[-1]
        obstacles = np.asarray(pred["obstacles"])
        # the swept corridor covers the box (and its leftward drift)
        assert obstacles[0, 0] <= 20.0 and obstacles[0, 1] >= 24.0
        # planned path is finite and actually dodges: at the obstacle
        # stations the path leaves the blocked lateral band
        path = np.asarray(traj["path_l"])
        assert np.isfinite(path).all()
        s_hit = slice(int(obstacles[0, 0]), int(np.ceil(obstacles[0, 1])))
        blocked_lo, blocked_hi = obstacles[0, 2], obstacles[0, 3]
        inside = ((path[s_hit] > blocked_lo)
                  & (path[s_hit] < blocked_hi))
        assert not inside.any(), (path[s_hit], obstacles[0])
        # controller tracks the dodging path: bounded transient during
        # the swerve, settled by the end of the horizon
        assert ctl["max_e_lat"] < 0.9
        assert ctl["max_e_station"] < 3.0
        assert np.isfinite(ctl["steer"]).all()


# ------------------------------------------------- against the JAX package

def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("v", [0.05, 2.0, 8.0, 15.0, 30.0])
def test_lateral_gain_matches_the_jax_package(v):
    import jax.numpy as jnp
    from tosem_tpu.models import control as ref
    want = ref.lateral_gain(ref.VehicleParams(), jnp.float32(v), dt=0.1)
    got = lateral_gain(VehicleParams(), torch.tensor(v), dt=0.1)
    assert got.shape == want.shape == (1, 4)
    assert _rel(got, want) <= CTL_TOL


def _rollout_case(seed):
    rng = np.random.default_rng(seed)
    path = np.cumsum(rng.normal(0, 0.05, 64)).astype(np.float32)
    sprof = (np.arange(40) * 0.25 * rng.uniform(4, 10)
             + np.cumsum(rng.normal(0, 0.05, 40))).astype(np.float32)
    init = (0.0, float(rng.uniform(-1, 1)), 0.0, float(rng.uniform(4, 10)))
    return path, sprof, init


@pytest.mark.parametrize("seed", range(3))
def test_track_trajectory_matches_the_jax_package(seed):
    import jax.numpy as jnp
    from tosem_tpu.models import control as ref
    path, sprof, init = _rollout_case(seed)
    want = ref.track_trajectory(jnp.asarray(path), jnp.asarray(sprof),
                                init=init)
    got = track_trajectory(path, sprof, init=init, device=CPU)
    for key in ("s", "l", "v", "steer", "accel", "e_lat", "e_station",
                "max_e_lat", "max_e_station"):
        assert got[key].shape == want[key].shape, key
        assert _rel(got[key], want[key]) <= CTL_TOL, key


def test_track_candidates_match_the_jax_package():
    import jax.numpy as jnp
    from tosem_tpu.models import control as ref
    cases = [_rollout_case(s) for s in range(3)]
    paths = np.stack([c[0][:48] for c in cases])
    sprof = cases[0][1][:24]
    want = ref.track_candidates(jnp.asarray(paths), jnp.asarray(sprof),
                                n_steps=24)
    got = track_candidates(torch.from_numpy(paths), torch.from_numpy(sprof),
                           n_steps=24)
    for key in ("l", "steer", "accel", "e_lat", "max_e_lat"):
        assert got[key].shape == want[key].shape, key
        assert _rel(got[key], want[key]) <= CTL_TOL, key


@pytest.mark.parametrize("seed", range(4))
def test_prediction_rows_match_the_jax_package(seed):
    from tosem_tpu.models import prediction as ref
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(4):
        k = int(rng.integers(0, 4))
        frames.append([{"track_id": int(rng.integers(0, 4)),
                        "box": [float(x) for x in
                                rng.uniform(-10, 40, 2).tolist()
                                + rng.uniform(1, 5, 2).tolist()]}
                       for _ in range(k)])
    est, ref_est = TrackVelocityEstimator(0.5), ref.TrackVelocityEstimator(0.5)
    for tracks in frames:
        for t in tracks:                  # (x0, y0, w, h) → corners
            b = t["box"]
            t["box"] = [b[0], b[1] / 10, b[0] + b[2], b[1] / 10 + b[3]]
        vels, want_v = est.update(tracks), ref_est.update(tracks)
        assert np.array_equal(vels, want_v)
        boxes = np.asarray([t["box"] for t in tracks],
                           np.float32).reshape(-1, 4)
        assert np.array_equal(predict_rollout(boxes, vels, horizon=2.0),
                              ref.predict_rollout(boxes, want_v,
                                                  horizon=2.0))
        for max_k in (1, 3):
            assert np.array_equal(
                swept_obstacles(boxes, vels, horizon=2.0, max_k=max_k),
                np.asarray(ref.swept_obstacles(boxes, want_v, horizon=2.0,
                                               max_k=max_k)))
