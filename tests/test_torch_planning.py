"""The port's planner (``models/planning.py``), held to the JAX package's
own tests and to the JAX package.

Copies of ``tests/test_planning.py``'s fifteen tests against
:mod:`tosem_tpu_torch.models.planning` on the CPU (``vmap`` becomes the
planner's own batch axis). Across packages, over seeded obstacle sets
and fences: the corridor bounds exactly, the chosen candidate and the
last penalty iteration's active walls equal (the JAX package's walls
read at its iterate after ``n_iter - 1`` steps), and the continuous
outputs within ``DRIVE_TOL`` (``models/control.py``) of the largest
value: 1e-4 for a path (and its cost) whose last iteration had no
active wall, 1e-1 for one that had (the 1e4 walls make the system
ill-conditioned: the JAX package's own fp32 paths sit up to 5.2e-2 from
a float64 run of the same method on these sets), 5e-3 for speed
profiles and 1e-3 for their costs.
"""
import numpy as np
import pytest
import torch

from tosem_tpu_torch.models.control import DRIVE_TOL
from tosem_tpu_torch.models.planning import (EMPTY_OBSTACLE,
                                             corridor_candidates, plan_path,
                                             plan_speed, solve_corridor)

torch.set_num_threads(1)
CPU = "cpu"


def _pad(rows, k=3):
    rows = list(rows)
    while len(rows) < k:
        rows.append(EMPTY_OBSTACLE)
    return np.asarray(rows, np.float32)


class TestPath:
    def test_free_road_stays_centered(self):
        l, cost, _ = plan_path(_pad([]), n=64, device=CPU)
        assert float(l.abs().max()) < 0.05
        assert float(cost) < 1.0

    def test_single_obstacle_is_avoided_smoothly(self):
        # box blocking the right half of the lane at s in [20, 30]
        obs = _pad([(20.0, 30.0, -1.75, 0.5)])
        l, cost, best = plan_path(obs, n=64, device=CPU)
        l = l.numpy()
        s = np.arange(64) * 1.0
        inside = (s >= 20) & (s <= 30)
        lane_half = 1.75
        assert np.all(l[inside] >= 0.5 - 1e-3)   # passes left
        assert np.all(np.abs(l) <= lane_half + 1e-3)
        # smooth: bounded third difference (comfort, the jerk term)
        dddl = np.diff(l, 3)
        assert np.max(np.abs(dddl)) < 0.2
        # returns toward center after the obstacle
        assert abs(float(l[-1])) < 0.3

    def test_pass_side_follows_the_gap(self):
        # obstacle hugging the LEFT edge → the free gap is on the right
        obs = _pad([(20.0, 30.0, 0.2, 1.75)])
        l, _, _ = plan_path(obs, n=64, device=CPU)
        s = np.arange(64) * 1.0
        inside = (s >= 20) & (s <= 30)
        assert np.all(l.numpy()[inside] <= 0.2 + 1e-3)   # passes right

    def test_two_obstacles_weave(self):
        obs = _pad([(15.0, 22.0, -1.75, 0.0),      # right half blocked
                    (35.0, 42.0, 0.0, 1.75)])      # then left half
        l, cost, _ = plan_path(obs, n=64, device=CPU)
        s = np.arange(64) * 1.0
        la = l.numpy()
        assert np.all(la[(s >= 15) & (s <= 22)] >= -1e-3)
        assert np.all(la[(s >= 35) & (s <= 42)] <= 1e-3)
        assert float(cost) < 1e6                   # a feasible weave won

    def test_batched_candidates_and_argmin(self):
        obs = _pad([(20.0, 30.0, -1.75, 0.5)], k=2)
        lowers, uppers = corridor_candidates(64, 1.0, 1.75, obs, device=CPU)
        assert lowers.shape == (4, 64)             # 2^K candidates
        # the blocked-right candidate(s) must cost more than pass-left
        paths, costs = solve_corridor(lowers, uppers, ds=1.0,
                                      init=(0.0, 0.0))
        assert float(costs.min()) < float(costs.max())

    def test_initial_state_anchoring(self):
        l, _, _ = plan_path(_pad([]), n=64, init=(0.8, -0.1), device=CPU)
        assert abs(float(l[0]) - 0.8) < 1e-2
        assert abs(float(l[1] - l[0]) - (-0.1)) < 2e-2   # ds = 1

    def test_fully_blocked_station_reports_infeasible_cost(self):
        # overlapping obstacles spilling past both lane edges: every
        # pass-side corridor is empty somewhere → all candidates
        # infeasible, and the planner says so instead of pretending
        obs = _pad([(20.0, 30.0, -1.8, 0.1),
                    (20.0, 30.0, -0.1, 1.8)])
        _, cost, _ = plan_path(obs, n=64, device=CPU)
        assert not np.isfinite(float(cost))


class TestSpeed:
    def test_cruise_tracks_reference_speed(self):
        s, _ = plan_speed(1e9, n_t=40, dt=0.25, v_init=8.0, v_ref=8.0,
                          device=CPU)
        s = s.numpy()
        v = np.diff(s) / 0.25
        assert abs(v.mean() - 8.0) < 0.3
        assert np.all(v >= -1e-3)                  # never reverses

    def test_stop_fence_is_respected(self):
        s, cost = plan_speed(30.0, n_t=40, dt=0.25, v_init=8.0, v_ref=8.0,
                             device=CPU)
        s = s.numpy()
        assert np.isfinite(float(cost))
        assert s.max() <= 30.0 + 0.1               # stops before the fence
        v = np.diff(s) / 0.25
        assert np.all(v >= -1e-2)
        assert v[-1] < 1.0                         # actually slowing/stopped
        a = np.diff(v) / 0.25
        assert np.max(np.abs(a)) < 8.0             # no slam-stop

    def test_profiles_jit_batch(self):
        """Many stop hypotheses in one batched solve."""
        fences = torch.tensor([15.0, 30.0, 60.0, 1e9])
        profs, costs = plan_speed(fences, n_t=40, dt=0.25)
        assert np.all(np.isfinite(costs.numpy()))
        ends = profs[:, -1].numpy()
        assert ends[0] <= 15.1 and ends[1] <= 30.1
        assert ends[3] > ends[1] > ends[0]


class TestPerceptionHandoff:
    def test_tracks_to_path(self):
        """Perception tracks → Frenet obstacles → planned path: the
        detect→track→plan pipeline end (onboard flow, minimal)."""
        from tosem_tpu_torch.models.perception import Track
        from tosem_tpu_torch.models.planning import obstacles_from_tracks
        tracks = [Track(track_id=1,
                        box=np.array([22.0, -1.75, 28.0, 0.4]),
                        score=0.9)]
        obs = obstacles_from_tracks(tracks, max_k=3)
        assert obs.shape == (3, 4)
        l, cost, _ = plan_path(obs, n=48, device=CPU)
        s = np.arange(48) * 1.0
        inside = (s >= 22) & (s <= 28)
        assert np.all(l.numpy()[inside] >= 0.4 - 1e-3)
        assert np.isfinite(float(cost))

    def test_impossible_stop_is_flagged_by_cost(self):
        """A fence inside braking distance cannot be honored; the cost
        must carry the violation instead of silently pretending."""
        s_ok, c_ok = plan_speed(60.0, n_t=40, dt=0.25, v_init=8.0,
                                v_ref=8.0, device=CPU)
        s_bad, c_bad = plan_speed(1.0, n_t=40, dt=0.25, v_init=8.0,
                                  v_ref=8.0, device=CPU)
        assert float(c_bad) > 10 * float(c_ok)

    def test_nearest_tracks_kept_under_truncation(self):
        from tosem_tpu_torch.models.perception import Track
        from tosem_tpu_torch.models.planning import obstacles_from_tracks
        far = [Track(track_id=i, box=np.array([40.0 + i, -1.0,
                                               45.0 + i, 1.0]), score=0.5)
               for i in range(3)]
        near = Track(track_id=9, box=np.array([10.0, -1.0, 15.0, 1.0]),
                     score=0.9)
        obs = obstacles_from_tracks(far + [near], max_k=3)
        assert float(obs[:, 0].min()) == 10.0   # the near box survived

    def test_behind_ego_tracks_do_not_evict_ahead(self):
        """Regression: behind-ego boxes (s < 0) must not consume the
        max_k slots and let the planner drive through a box ahead."""
        from tosem_tpu_torch.models.perception import Track
        from tosem_tpu_torch.models.planning import obstacles_from_tracks
        behind = [Track(track_id=i, box=np.array([-33.0 - i, -1.0,
                                                  -25.0 - i, 1.0]),
                        score=0.5) for i in range(3)]
        ahead = Track(track_id=9, box=np.array([20.0, -1.75, 25.0, 0.4]),
                      score=0.9)
        obs = obstacles_from_tracks(behind + [ahead], max_k=3)
        l, cost, _ = plan_path(obs, n=48, device=CPU)
        s = np.arange(48) * 1.0
        inside = (s >= 20) & (s <= 25)
        assert np.all(l.numpy()[inside] >= 0.4 - 1e-3)


class TestPlannerFuzz:
    def test_random_obstacle_sets_never_nan(self):
        """Property sweep: any random (possibly degenerate) obstacle set
        must yield a finite path inside the lane band; cost may be inf
        only when every corridor is infeasible."""
        from tosem_tpu_torch.models.planning import pad_obstacle_rows

        rng = np.random.default_rng(7)
        for trial in range(25):
            k = int(rng.integers(0, 4))
            raw = rng.uniform(-10.0, 70.0, (k, 4))
            # random degeneracies: swapped corners, behind-ego, off-lane
            rows = [(r[0], r[1], r[2] / 20.0, r[3] / 20.0) for r in raw]
            obstacles = pad_obstacle_rows(rows, max_k=3)
            path, cost, idx = plan_path(obstacles, n=32, ds=1.0,
                                        device=CPU)
            path = path.numpy()
            assert np.isfinite(path).all(), (trial, rows)
            assert (np.abs(path) <= 1.75 + 0.75).all(), (trial, path)
            assert np.isfinite(float(cost)) or float(cost) == np.inf


# ------------------------------------------------- against the JAX package

N = 48


def _obstacle_set(seed):
    """0-3 seeded boxes ahead, some overlapping or spanning the lane,
    padded to 3 rows by the JAX package's own ``pad_obstacle_rows``."""
    from tosem_tpu.models.planning import pad_obstacle_rows
    rng = np.random.default_rng(seed)
    k = int(rng.integers(0, 4))
    rows = []
    for s0, span in rng.uniform(-5.0, 60.0, (k, 2)):
        l0 = rng.uniform(-2.0, 1.5)
        rows.append((s0, s0 + abs(span) / 6 + 1, l0,
                     l0 + rng.uniform(0.3, 3.0)))
    return np.asarray(pad_obstacle_rows(rows, max_k=3))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cost_gap(got, want):
    got, want = float(got), float(want)
    if not np.isfinite(want):
        return 0.0 if got == want else np.inf
    return abs(got - want) / max(abs(want), 1e-30)


@pytest.mark.parametrize("seed", range(24))
def test_plan_path_matches_the_jax_package(seed):
    import jax.numpy as jnp
    from tosem_tpu.models import planning as ref
    obs = _obstacle_set(seed)
    jl, ju = ref.corridor_candidates(N, 1.0, 1.75, jnp.asarray(obs))
    jp, jc, ji = ref.plan_path(jnp.asarray(obs), n=N)
    lowers, uppers = corridor_candidates(N, 1.0, 1.75, obs, device=CPU)
    assert np.array_equal(lowers.numpy(), np.asarray(jl))
    assert np.array_equal(uppers.numpy(), np.asarray(ju))
    path, cost, idx, det = plan_path(obs, n=N, device=CPU, detail=True)
    assert int(idx) == int(ji), det["cost_margin"]
    # the JAX package's last-iteration walls: at its iterate after
    # n_iter - 1 = 7 steps, the one the last solve answered
    lo, hi = np.asarray(jl)[int(ji)], np.asarray(ju)[int(ji)]
    x7, _ = ref.solve_corridor(jnp.asarray(lo), jnp.asarray(hi), ds=1.0,
                               init=(0.0, 0.0), n_iter=7)
    want_walls = np.stack([np.asarray(x7) < lo, np.asarray(x7) > hi])
    assert np.array_equal(det["walls"].numpy(), want_walls), \
        float(det["wall_margin"])
    walls = "_walls" if want_walls.any() else ""
    assert _rel(path, jp) <= DRIVE_TOL["path_l" + walls]
    assert _cost_gap(cost, jc) <= DRIVE_TOL["path_cost" + walls]


def _walls_at(x, lo, hi):
    x = np.asarray(x)
    return np.stack([x < lo, x > hi], -2)


@pytest.mark.parametrize("seed", range(100, 112))
def test_solve_corridor_matches_the_jax_package(seed):
    """All 2^K corridors of a set, as one batched solve. Which are
    infeasible always matches. A corridor whose penalty iterations
    settled in both packages (the last iteration's walls are the final
    profile's) has the same walls, its cost and profile within
    DRIVE_TOL. One that did not settle is noise in any fp32 run: sets
    101-111 settle where both packages' do, while set 100's unsettled
    candidates part by metres from a float64 run of the same method in
    the JAX package as in the port, so they are not compared."""
    import jax
    import jax.numpy as jnp
    from tosem_tpu.models import planning as ref
    obs = _obstacle_set(seed)
    jl, ju = ref.corridor_candidates(N, 1.0, 1.75, jnp.asarray(obs))
    lo, hi = np.array(jl), np.array(ju)

    def solve(n_iter):
        return jax.vmap(lambda a, b: ref.solve_corridor(
            a, b, ds=1.0, init=(0.0, 0.0), n_iter=n_iter))(jl, ju)
    (jx, jcosts), (jx7, _) = solve(8), solve(7)
    x, costs, walls, _ = solve_corridor(
        torch.from_numpy(lo), torch.from_numpy(hi), ds=1.0, init=(0.0, 0.0),
        detail=True)
    assert np.array_equal(np.isfinite(costs.numpy()),
                          np.isfinite(np.asarray(jcosts)))
    want_walls, walls = _walls_at(jx7, lo, hi), walls.numpy()
    for c in range(lo.shape[0]):
        if not (np.array_equal(want_walls[c], _walls_at(jx[c], lo[c], hi[c]))
                and np.array_equal(walls[c],
                                   _walls_at(x[c], lo[c], hi[c]))):
            continue
        assert np.array_equal(walls[c], want_walls[c])
        tag = "_walls" if walls[c].any() else ""
        assert _rel(x[c], jx[c]) <= DRIVE_TOL["path_l" + tag]
        assert _cost_gap(costs[c], jcosts[c]) <= DRIVE_TOL["path_cost" + tag]


@pytest.mark.parametrize("seed", range(12))
def test_plan_speed_matches_the_jax_package(seed):
    import jax.numpy as jnp
    from tosem_tpu.models import planning as ref
    rng = np.random.default_rng(seed)
    fence = float(rng.uniform(2.0, 70.0))
    v_ref = float(rng.choice([0.0, 5.0, 8.0]))
    js, jc = ref.plan_speed(jnp.float32(fence), v_ref=v_ref)
    ps, pc = plan_speed(fence, v_ref=v_ref, device=CPU)
    assert _rel(ps, js) <= DRIVE_TOL["s_profile"]
    assert _cost_gap(pc, jc) <= DRIVE_TOL["speed_cost"]
