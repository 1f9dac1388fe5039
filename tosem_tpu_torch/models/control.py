"""Control-lite — LQR lateral + cascaded-PID longitudinal, on tensors.

The reference's control module tracks the planned trajectory with two
controllers (``modules/control/controller/``): ``lat_controller.cc`` —
a dynamic-bicycle error model in the state
``[e_lat, e_lat_rate, e_heading, e_heading_rate]``, bilinear-discretized
and fed to a discrete LQR solved by iterative Riccati recursion
(``modules/common/math/linear_quadratic_regulator.cc``) — and
``lon_controller.cc`` — a cascaded PID (station error corrects the
speed setpoint, speed error produces the acceleration command).

The port's counterpart of ``tosem_tpu/models/control.py``:

- the Riccati recursion is a fixed-trip Python loop of tensor ops (the
  JAX package's ``fori_loop``; a 1 × 1 ``R + BᵀPB`` system is solved by
  its division),
- the closed-loop tracking rollout over the planned trajectory is a
  Python loop over the steps (the JAX package's ``lax.scan``), and
- candidate trajectories are evaluated **as one batch**: every tensor of
  the rollout carries the candidates' leading axis (the JAX package's
  ``vmap``).

Everything is Frenet, matching :mod:`tosem_tpu_torch.models.planning`:
``ds/dt = v·cos(e_psi)``, ``dl/dt = v·sin(e_psi)``. Tensors are fp32 with
TF32 off; divisions by a step size divide by a device tensor (a CUDA
division by a Python scalar multiplies by its reciprocal). Functions run
on their tensors' device, or ``device`` (default ``"cuda"``); the
components take ``device`` and raise where it is absent.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from tosem_tpu_torch.dataflow.components import Component
from tosem_tpu_torch.ops.common import (as_f32, pick_device, precision,
                                         resolve_device)

__all__ = ["DRIVE_TOL", "VehicleParams", "PidGains", "bicycle_matrices",
           "discretize", "lqr_gain", "lateral_gain", "track_trajectory",
           "track_candidates", "drive_gaps", "PlanningComponent",
           "ControlComponent", "build_driving_pipeline"]

_F32 = torch.float32

# How far two fp32 runs of the stack may part (another LU, another
# summation order: the JAX package against the port, the card against
# the CPU), relative to the largest |value| of the reference run; a
# cost relative to itself; steer and accel relative to their actuator
# limits (VehicleParams.steer_limit, accel_limit). The penalty method's
# 1e4 walls make its systems ill-conditioned: where the path's last
# iteration had an active wall, the JAX package's own fp32 paths and
# costs sit up to 5.2e-2 and 5.0e-2 from a float64 run of the same
# method (tests/test_torch_planning.py's sets), so two fp32 runs may
# part by twice that; a wall-free path parts by 2.3e-5 at most. Speed
# profiles resting on their fence part by up to 2.3e-3. Steering feeds
# forward the path's curvature, a second difference that magnifies the
# path's gap: 3.8e-2 of the limit in the 100-frame soak
# (tests/test_torch_scenario.py), accel 0.9e-2 in the quickstart's
# drive.
DRIVE_TOL = {"path_l": 1e-4, "path_l_walls": 1e-1, "path_cost": 1e-4,
             "path_cost_walls": 1e-1, "s_profile": 5e-3, "speed_cost": 1e-3,
             "steer": 5e-2, "accel": 5e-2, "pose": 1e-5}


@dataclass(frozen=True)
class VehicleParams:
    """Dynamic-bicycle parameters (the ``vehicle_param``/``control_conf``
    protobuf role, reduced to the fields the error model needs)."""
    mass: float = 1500.0          # kg
    c_f: float = 155e3            # front cornering stiffness, N/rad
    c_r: float = 155e3            # rear cornering stiffness, N/rad
    l_f: float = 1.2              # CG → front axle, m
    l_r: float = 1.6              # CG → rear axle, m
    i_z: float = 2500.0           # yaw inertia, kg·m²
    steer_limit: float = 0.5      # rad
    accel_limit: float = 3.0      # m/s²


@dataclass(frozen=True)
class PidGains:
    kp: float
    ki: float = 0.0
    kd: float = 0.0


# the entries of A that depend on v: (row, col) and the numerator over
# m·v (first two) or i_z·v (last two)
_V_ROWS, _V_COLS = (1, 1, 3, 3), (1, 3, 1, 3)


@functools.lru_cache(maxsize=16)
def _bicycle_consts(p: VehicleParams, device: str):
    """A with its v-free entries, B, and the v-entries' numerators, on
    ``device`` (each entry rounded from float64 once, as JAX rounds a
    Python number)."""
    m, cf, cr, lf, lr, iz = (p.mass, p.c_f, p.c_r, p.l_f, p.l_r, p.i_z)
    a = np.zeros((4, 4), np.float32)
    a[0, 1] = a[2, 3] = 1.0
    a[1, 2] = (cf + cr) / m
    a[3, 2] = (lf * cf - lr * cr) / iz
    b = np.array([[0.0], [cf / m], [0.0], [lf * cf / iz]], np.float32)
    num = np.array([-(cf + cr), lr * cr - lf * cf, lr * cr - lf * cf,
                    -(lf * lf * cf + lr * lr * cr)], np.float32)
    dev = torch.device(device)
    return (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
            torch.from_numpy(num).to(dev),
            torch.tensor(_V_ROWS, device=dev),
            torch.tensor(_V_COLS, device=dev))


def bicycle_matrices(p: VehicleParams, v) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Continuous error dynamics (A [..., 4, 4], B [4, 1]) at speed
    ``v`` (a tensor of any batch shape). Standard dynamic-bicycle
    lateral error model — the same state ordering as the reference's
    ``matrix_a_``/``matrix_b_``."""
    v = torch.as_tensor(v, dtype=_F32)
    a0, b, num, rows, cols = _bicycle_consts(p, str(v.device))
    v = torch.clamp_min(v, 0.1)   # the 1/v terms blow up at standstill
    mv, iv = p.mass * v, p.i_z * v
    den = torch.stack([mv, mv, iv, iv], -1)
    a = a0.expand(*v.shape, 4, 4).clone()
    a[..., rows, cols] = num / den
    return a, b


def discretize(a: torch.Tensor, b: torch.Tensor, dt: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear (Tustin) discretization — the reference's
    ``UpdateMatrix()`` scheme: ``Ad = (I − A·dt/2)⁻¹(I + A·dt/2)``,
    ``Bd = B·dt``."""
    with precision("float32"):
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        half = a * (dt / 2.0)
        ad = torch.linalg.solve_ex(eye - half, eye + half)[0]
    return ad, b * dt


def _solve_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a⁻¹ b``: a 1 × 1 system by its division, else an LU solve (no
    wait on the device either way)."""
    if a.shape[-1] == 1:
        return b / a
    return torch.linalg.solve_ex(a, b)[0]


def lqr_gain(ad: torch.Tensor, bd: torch.Tensor, q: torch.Tensor,
             r: torch.Tensor, n_iter: int = 100) -> torch.Tensor:
    """Discrete LQR gain by fixed-trip Riccati recursion.

    The reference iterates ``P ← AᵀPA − AᵀPB(R+BᵀPB)⁻¹BᵀPA + Q`` until a
    tolerance on the host; a fixed trip count keeps the synthesis a
    straight run of tensor ops, batched over any leading axes of ``ad``.
    Returns K [..., 1, 4] with the control law ``u = −K·x``.
    """
    with precision("float32"):
        ad_t, bd_t = ad.transpose(-1, -2), bd.transpose(-1, -2)
        pmat = q
        for _ in range(n_iter):
            btp = bd_t @ pmat
            gain = _solve_small(r + btp @ bd, btp @ ad)
            pmat = ad_t @ pmat @ (ad - bd @ gain) + q
        btp = bd_t @ pmat
        return _solve_small(r + btp @ bd, btp @ ad)


@functools.lru_cache(maxsize=16)
def _lqr_weights(q_diag, r: float, device: str):
    dev = torch.device(device)
    return (torch.diag(torch.tensor(q_diag, dtype=_F32)).to(dev),
            torch.tensor([[r]], dtype=_F32).to(dev))


def lateral_gain(params: VehicleParams, v, *, dt: float = 0.1,
                 q_diag: Tuple[float, float, float, float] =
                 (1.0, 0.0, 1.0, 0.0), r: float = 10.0,
                 n_iter: int = 100) -> torch.Tensor:
    """Speed-scheduled lateral LQR gain (the per-cycle gain synthesis of
    ``LatController::ComputeControlCommand``)."""
    v = torch.as_tensor(v, dtype=_F32)
    a, b = bicycle_matrices(params, v)
    ad, bd = discretize(a, b, dt)
    q, rr = _lqr_weights(tuple(float(x) for x in q_diag), float(r),
                         str(v.device))
    return lqr_gain(ad, bd, q, rr, n_iter=n_iter)


def _gradient(f: torch.Tensor) -> torch.Tensor:
    """``jnp.gradient`` at unit spacing along the last axis: one-sided
    differences at the ends, ``(f[i+1] - f[i-1]) * 0.5`` inside."""
    return torch.cat([f[..., 1:2] - f[..., 0:1],
                      (f[..., 2:] - f[..., :-2]) * 0.5,
                      f[..., -1:] - f[..., -2:-1]], -1)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
            ) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for a batch: ``x`` [...], ``xp`` [n]
    ascending, ``fp`` [..., n] (or [n]); ends held constant, as JAX's
    steps."""
    i = torch.searchsorted(xp, x.reshape(-1), right=True).reshape(
        x.shape).clamp(1, xp.shape[0] - 1)
    fpb = fp.expand(*x.shape, fp.shape[-1])
    f1 = torch.gather(fpb, -1, i[..., None])[..., 0]
    f0 = torch.gather(fpb, -1, (i - 1)[..., None])[..., 0]
    x1, x0 = xp[i], xp[i - 1]
    dx = x1 - x0
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(
        dx0, torch.ones_like(dx), dx)) * (f1 - f0))
    f = torch.where(x < xp[0], fpb[..., 0], f)
    return torch.where(x > xp[-1], fpb[..., -1], f)


def track_trajectory(path_l, s_profile, *, ds: float = 1.0,
                     dt: float = 0.25, n_steps: int = 40,
                     params: VehicleParams = VehicleParams(),
                     station_gains: PidGains = PidGains(0.3),
                     speed_gains: PidGains = PidGains(1.2, 0.1),
                     init: Tuple[float, float, float, float] =
                     (0.0, 0.0, 0.0, 8.0), device=None
                     ) -> Dict[str, torch.Tensor]:
    """Closed-loop tracking of a planned trajectory, one step at a time.

    ``path_l`` [..., n] is the planned lateral profile over stations
    ``s = arange(n)·ds`` (from :func:`planning.plan_path`); a leading
    axis is a batch of candidate paths. ``s_profile`` [n_t] is the
    planned station-vs-time profile (from :func:`planning.plan_speed`).
    The plant is the Frenet kinematic bicycle; steering comes from the
    speed-scheduled LQR over the 4-state error vector (rates by finite
    difference, the reference's estimation path), acceleration from the
    station→speed PID cascade.

    Returns the rollout ([..., T] per quantity) and tracking-quality
    summaries the pipeline asserts on (max lateral / station error).
    """
    dev = pick_device(device, path_l, s_profile)
    path_l = as_f32(path_l, dev)
    s_profile = as_f32(s_profile, dev)
    batch = path_l.shape[:-1]
    with precision("float32"):
        n = path_l.shape[-1]
        ds_t = torch.full((), ds, dtype=_F32, device=dev)
        dt_t = torch.full((), dt, dtype=_F32, device=dev)
        s_grid = torch.arange(n, dtype=_F32, device=dev) * ds
        heading_ref = _gradient(path_l) / ds_t     # dl/ds ≈ tan(ψ_ref)
        kappa_ref = _gradient(heading_ref) / ds_t  # path curvature
        v_ref_prof = _gradient(s_profile) / dt_t
        wheelbase = params.l_f + params.l_r
        wb_t = torch.full((), wheelbase, dtype=_F32, device=dev)

        def state(v):
            return torch.full(batch, float(v), dtype=_F32, device=dev)
        s, l, psi, v = (state(x) for x in init)
        prev_lat, prev_psi, integ = state(0.0), state(0.0), state(0.0)
        rows = {k: [] for k in ("s", "l", "v", "steer", "accel", "e_lat",
                                "e_station")}
        for t_idx in range(min(n_steps, s_profile.shape[0])):
            # --- lateral LQR ---
            tgt_l = _interp(s, s_grid, path_l)
            tgt_psi = torch.atan(_interp(s, s_grid, heading_ref))
            e_lat = l - tgt_l
            e_psi = psi - tgt_psi
            e = torch.stack([e_lat, (e_lat - prev_lat) / dt_t,
                             e_psi, (e_psi - prev_psi) / dt_t], -1)
            k = lateral_gain(params, v, dt=dt)
            # feedforward on the path curvature (the reference's
            # ComputeFeedForward term) so feedback only works off the
            # residual — without it the ego lags every swerve by ~1 m
            steer_ff = torch.atan(wheelbase * _interp(s, s_grid, kappa_ref))
            fb = (k @ e[..., None])[..., 0, 0]
            steer = torch.clamp(steer_ff - fb, -params.steer_limit,
                                params.steer_limit)
            # --- longitudinal cascade ---
            e_s = s_profile[t_idx] - s
            v_target = v_ref_prof[t_idx] + station_gains.kp * e_s
            e_v = v_target - v
            integ = integ + e_v * dt
            accel = torch.clamp(speed_gains.kp * e_v
                                + speed_gains.ki * integ,
                                -params.accel_limit, params.accel_limit)
            # --- Frenet kinematic bicycle plant ---
            psi = psi + v / wb_t * torch.tan(steer) * dt
            s = s + v * torch.cos(e_psi) * dt
            l = l + v * torch.sin(e_psi) * dt
            v = torch.clamp_min(v + accel * dt, 0.0)
            prev_lat, prev_psi = e_lat, e_psi
            for key, val in (("s", s), ("l", l), ("v", v), ("steer", steer),
                             ("accel", accel), ("e_lat", e_lat),
                             ("e_station", e_s)):
                rows[key].append(val)
        traj = {k: torch.stack(vals, -1) for k, vals in rows.items()}
        traj["max_e_lat"] = traj["e_lat"].abs().amax(-1)
        traj["max_e_station"] = traj["e_station"].abs().amax(-1)
    return traj


def track_candidates(paths, s_profile, **kw) -> Dict[str, torch.Tensor]:
    """Score a BATCH of candidate paths [B, n] with the controller in the
    loop — one batched rollout (:func:`track_trajectory` over the
    candidates' leading axis)."""
    return track_trajectory(paths, s_profile, **kw)


def _gap(got, want, scale=None) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale


def drive_gaps(got, want, params: VehicleParams = VehicleParams()):
    """Two runs of the driving stack, frame by frame: each frame a dict
    of the ``trajectory``, ``control`` and ``pose`` messages (``None``
    before the first). Returns ``(parted, worst)``: the discrete outputs
    that differ (scenario, candidate, stop fence, and the last penalty
    iteration's walls where both runs report them), each with the
    margins that decided it, and each continuous output's largest gap
    as a share of its :data:`DRIVE_TOL` entry (at most 1 when the runs
    agree)."""
    parted, worst = [], {}

    def note(key, ratio):
        worst[key] = max(worst.get(key, 0.0), ratio)
    for i, (g, w) in enumerate(zip(got, want)):
        gt, wt = g["trajectory"], w["trajectory"]
        for key in ("scenario", "candidate", "stop_fence"):
            if gt[key] != wt[key]:
                parted.append({"frame": i, "output": key, "got": gt[key],
                               "want": wt[key],
                               "cost_margin": gt.get("cost_margin")})
        walls = gt.get("active_walls")
        if walls is not None and wt.get("active_walls") is not None \
                and not np.array_equal(walls, wt["active_walls"]):
            parted.append({"frame": i, "output": "active_walls",
                           "wall_margin": gt["wall_margin"],
                           "want_wall_margin": wt["wall_margin"],
                           "settled": gt["walls_settled"]})
        ref_walls = wt.get("active_walls", walls)
        tag = "_walls" if ref_walls is not None and np.any(ref_walls) \
            else ""
        note("path_l", _gap(gt["path_l"], wt["path_l"])
             / DRIVE_TOL["path_l" + tag])
        note("s_profile", _gap(gt["s_profile"], wt["s_profile"])
             / DRIVE_TOL["s_profile"])
        if (g["control"] is None) != (w["control"] is None):
            parted.append({"frame": i, "output": "control"})
        elif g["control"] is not None:
            for key, limit in (("steer", params.steer_limit),
                               ("accel", params.accel_limit)):
                note(key, _gap(g["control"][key], w["control"][key],
                               limit) / DRIVE_TOL[key])
        if (g["pose"] is None) != (w["pose"] is None):
            parted.append({"frame": i, "output": "pose"})
        elif g["pose"] is not None:
            pose = [np.concatenate([np.asarray(p["pos"], np.float64).ravel(),
                                    [p["yaw"], p["v"]]])
                    for p in (g["pose"], w["pose"])]
            note("pose", _gap(*pose) / DRIVE_TOL["pose"])
    return parted, worst


# ---------------------------------------------------------------------------
# pipeline components: prediction → planning → control
# ---------------------------------------------------------------------------


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class PlanningComponent(Component):
    """predicted obstacles → planned trajectory (the on-road planning
    component role: runs the batched corridor planner each frame on
    ``device``).

    Besides the JAX package's fields the trajectory carries the decisions
    the planner made and their margins: ``active_walls`` ([2, n] bool,
    the chosen corridor's walls in the penalty method's last iteration),
    ``wall_margin`` (the least ``|l - bound|`` there), ``walls_settled``
    (those walls are the final profile's too) and ``cost_margin`` (the
    cheapest differing candidate's cost minus the chosen one's)."""

    def __init__(self, *, in_channel: str = "predicted_obstacles",
                 out_channel: str = "trajectory", n: int = 64,
                 ds: float = 1.0, lane_half: float = 1.75,
                 n_t: int = 40, dt: float = 0.25, v_init: float = 8.0,
                 min_pass_gap: float = 0.4, device="cuda"):
        super().__init__("planning", [in_channel])
        self.device = resolve_device(device)
        self.out_channel = out_channel
        self.n, self.ds, self.lane_half = n, ds, lane_half
        self.n_t, self.dt, self.v_init = n_t, dt, v_init
        # lateral clearance needed to squeeze past an obstacle on
        # either side; a corridor leaving less than this on BOTH sides
        # is a full-lane blocker and forces a stop fence
        self.MIN_PASS_GAP = min_pass_gap

    def on_init(self, ctx):
        self._write = ctx.writer(self.out_channel)

    def _stop_fence(self, obstacles: np.ndarray,
                    hard: bool = False) -> float:
        """Nearest obstacle that blocks both pass sides (no room above
        l1 nor below l0 inside the lane band) → stop short of it; else
        the end of the planning horizon. The ST-boundary 'stop decision'
        of the reference's speed-bounds decider, reduced to statics.
        ``hard`` (the emergency scenario) fences the nearest LIVE
        obstacle even when the pass-gap rule would allow dodging."""
        from tosem_tpu_torch.models.planning import (blocks_lane,
                                                     live_obstacle_rows)
        fence = (self.n - 1) * self.ds
        for row in live_obstacle_rows(obstacles):
            if hard or blocks_lane(row, lane_half=self.lane_half,
                                   min_pass_gap=self.MIN_PASS_GAP):
                fence = min(fence, max(row[0] - 1.0, 0.0))
        return fence

    def proc(self, pred, *fused):
        from tosem_tpu_torch.models.planning import plan_path, plan_speed
        path, cost, idx, det = plan_path(
            np.asarray(pred["obstacles"], np.float32), n=self.n,
            ds=self.ds, lane_half=self.lane_half, device=self.device,
            detail=True)
        # a scenario layer may parameterize the same optimizers: target
        # speed and a hard (brake-now) fence ride in the request
        v_ref = float(pred.get("v_ref", self.v_init))
        fence = self._stop_fence(pred["obstacles"],
                                 hard=bool(pred.get("hard_fence")))
        sprof, scost = plan_speed(fence, n_t=self.n_t, dt=self.dt,
                                  v_init=self.v_init, v_ref=v_ref,
                                  device=self.device)
        scalars = _host(torch.stack([cost, idx.to(_F32), det["wall_margin"],
                                     det["cost_margin"],
                                     det["settled"].to(_F32)]))
        self._write({"path_l": _host(path),
                     "s_profile": _host(sprof),
                     "cost": float(scalars[0]),
                     "candidate": int(scalars[1]),
                     "stop_fence": float(fence),
                     "scenario": pred.get("scenario"),
                     "v_ref": v_ref,
                     "active_walls": _host(det["walls"]),
                     "wall_margin": float(scalars[2]),
                     "cost_margin": float(scalars[3]),
                     "walls_settled": bool(scalars[4])})


def build_driving_pipeline(runtime, *, lane_half: float = 1.75,
                           min_pass_gap: float = 0.4,
                           cruise_v: float = 8.0, avoid_v: float = 5.0,
                           n: int = 64, ds: float = 1.0,
                           frame_dt: float = 0.1, horizon: float = 5.0,
                           max_k: int = 3,
                           params: VehicleParams = VehicleParams(),
                           localize: bool = False, device="cuda"):
    """Wire prediction → scenario → planning → control with ONE shared
    geometry (lane_half / pass gap / speeds) so the scenario rules and
    the planner's fence can never disagree about which obstacles block
    — the wiring-level guarantee the shared predicates alone cannot
    give. Returns the four components after adding them to ``runtime``.

    ``localize=True`` also mounts the EKF localization branch
    (imu + gnss → pose; ``models/localization.py``) — the pose stream
    the reference's driving DAG feeds every module from
    (``rtk_localization_component.cc``); it is returned appended.
    Planning, control and localization run on ``device``.
    """
    from tosem_tpu_torch.models.prediction import PredictionComponent
    from tosem_tpu_torch.models.scenario import (ScenarioComponent,
                                                 ScenarioManager)
    device = resolve_device(device)
    pred = PredictionComponent(frame_dt=frame_dt, horizon=horizon,
                               lane_half=lane_half, max_k=max_k)
    scen = ScenarioComponent(ScenarioManager(
        cruise_v=cruise_v, avoid_v=avoid_v, lane_half=lane_half,
        min_pass_gap=min_pass_gap))
    plan = PlanningComponent(in_channel="planning_request", n=n, ds=ds,
                             lane_half=lane_half, v_init=cruise_v,
                             min_pass_gap=min_pass_gap, device=device)
    ctl = ControlComponent(params=params, ds=ds, device=device)
    comps = [pred, scen, plan, ctl]
    if localize:
        from tosem_tpu_torch.models.localization import (
            EkfParams, LocalizationComponent)
        comps.append(LocalizationComponent(
            x0=(0.0, 0.0, 0.0, cruise_v),
            params=EkfParams(dt=frame_dt), device=device))
    for c in comps:
        runtime.add(c)
    return tuple(comps)


class ControlComponent(Component):
    """planned trajectory → actuation commands + tracking errors
    (the ``controller_agent.cc`` role: lat LQR + lon PID per frame, on
    ``device``)."""

    def __init__(self, *, in_channel: str = "trajectory",
                 out_channel: str = "control",
                 params: VehicleParams = VehicleParams(),
                 ds: float = 1.0, dt: float = 0.25, n_steps: int = 40,
                 device="cuda"):
        super().__init__("control", [in_channel])
        self.device = resolve_device(device)
        self.out_channel = out_channel
        self.params, self.ds, self.dt, self.n_steps = (params, ds, dt,
                                                       n_steps)

    def on_init(self, ctx):
        self._write = ctx.writer(self.out_channel)

    def proc(self, traj, *fused):
        roll = track_trajectory(
            np.asarray(traj["path_l"], np.float32),
            np.asarray(traj["s_profile"], np.float32),
            ds=self.ds, dt=self.dt, n_steps=self.n_steps,
            params=self.params, device=self.device)
        out = _host(torch.cat([roll["steer"], roll["accel"],
                               roll["max_e_lat"][None],
                               roll["max_e_station"][None]]))
        t = roll["steer"].shape[-1]
        self._write({"steer": out[:t], "accel": out[t:2 * t],
                     "max_e_lat": float(out[2 * t]),
                     "max_e_station": float(out[2 * t + 1])})
