"""Localization-lite: RTK pose composition + error-state EKF fusion.

The reference localizes two ways (``modules/localization/README.md``):
RTK — buffer IMU, interpolate to each GNSS fix's timestamp, compose a
pose (``modules/localization/rtk/rtk_localization.cc:1``, list search +
linear interpolation per fix on the host) — and MSF — an error-state
Kalman filter fusing IMU propagation with GNSS/LiDAR updates
(``modules/localization/msf/local_integ/localization_integ.cc:1``, the
ICRA'18 multi-sensor fusion pipeline).

The port's counterpart of ``tosem_tpu/models/localization.py``, planar
(the study's driving pipeline is 2D):

- **RTK**: the whole fix batch at once — ``torch.searchsorted`` over the
  IMU ring + gathered linear interpolation, one call for ALL fixes
  instead of a per-fix list walk.
- **EKF**: a loop of tensor steps over the IMU samples (the JAX
  package's ``lax.scan``) with a *masked* GNSS update: gain and
  innovation are computed every step and zeroed by the fix mask —
  branchless, so the same ops run whether or not a fix arrived, and a
  leading axis of ``x0`` runs a fleet in one batch (the JAX package's
  ``vmap``). State [px, py, yaw, v], inputs [yaw_rate, accel];
  covariance carried explicitly (4x4).

``LocalizationComponent`` bridges onto the component runtime: fuses the
``imu`` stream (primary, high rate) with the latest ``gnss`` fix and
publishes ``pose`` messages for the driving pipeline — the
``rtk_localization_component.cc`` role under Apollo fusion semantics. It
keeps its state, ``x`` and ``P``, on its device. Tensors are fp32 with
TF32 off; functions run on their tensors' device, or ``device`` (default
``"cuda"``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from tosem_tpu_torch.dataflow.components import Component
from tosem_tpu_torch.ops.common import (as_f32, pick_device, precision,
                                         resolve_device)

__all__ = ["EkfParams", "ekf_localize", "dead_reckon", "rtk_interpolate",
           "LocalizationComponent"]

_F32 = torch.float32


@dataclass(frozen=True)
class EkfParams:
    """Noise model (the ``localization_integ`` tuning-knob role)."""
    dt: float = 0.01                 # IMU period (100 Hz, Apollo's rate)
    q_pos: float = 1e-4              # process noise, position
    q_yaw: float = 1e-5              # process noise, heading
    q_v: float = 1e-2                # process noise, speed
    r_gnss: float = 0.25             # GNSS position variance (m^2)
    p0: float = 1.0                  # initial covariance diagonal


def _propagate(x: torch.Tensor, u: torch.Tensor, dt: float):
    """Nonlinear motion model + its Jacobian (analytic: 4x4 is small
    enough that the closed form keeps the step lean).

    x = [..., (px, py, yaw, v)]; u = [(yaw_rate, accel)].
    """
    px, py, yaw, v = x.unbind(-1)
    w, a = u.unbind(-1)
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    x_new = torch.stack([px + v * cos * dt, py + v * sin * dt,
                         yaw + w * dt, v + a * dt], -1)
    zero, one = torch.zeros_like(v), torch.ones_like(v)
    f = torch.stack([
        torch.stack([one, zero, -v * sin * dt, cos * dt], -1),
        torch.stack([zero, one, v * cos * dt, sin * dt], -1),
        torch.stack([zero, zero, one, zero], -1),
        torch.stack([zero, zero, zero, one], -1)], -2)
    return x_new, f


def _ekf_step(x, p, u, z, m, q, r, h, dt):
    """One masked EKF step: propagate, then an update scaled by ``m``."""
    x_pred, f = _propagate(x, u, dt)
    p_pred = f @ p @ f.transpose(-1, -2) + q
    s = h @ p_pred @ h.T + r
    k = p_pred @ h.T @ torch.linalg.inv_ex(s)[0]
    k = k * m                          # masked gain: no fix -> no update
    innov = z - (h @ x_pred[..., None])[..., 0]
    x_new = x_pred + (k @ innov[..., None])[..., 0]
    eye = torch.eye(4, dtype=x.dtype, device=x.device)
    p_new = (eye - k @ h) @ p_pred
    return x_new, p_new


def _ekf_consts(params: EkfParams, device):
    q = torch.diag(torch.tensor([params.q_pos, params.q_pos, params.q_yaw,
                                 params.q_v], dtype=_F32)).to(device)
    r = (torch.eye(2, dtype=_F32) * params.r_gnss).to(device)
    h = torch.zeros(2, 4, dtype=_F32)
    h[0, 0] = h[1, 1] = 1.0
    return q, r, h.to(device)


def ekf_localize(x0, imu, gnss, gnss_mask,
                 params: EkfParams = EkfParams(),
                 p0: Optional[torch.Tensor] = None, device=None):
    """Run the error-state EKF over a whole trajectory.

    Args:
      x0:        [..., 4] initial state [px, py, yaw, v] (a leading axis
                 runs a fleet).
      imu:       [T, 2] per-step [yaw_rate, accel].
      gnss:      [T, 2] per-step GNSS position (ignored where masked out).
      gnss_mask: [T] 1.0 where a fix arrived this step, else 0.0.
      p0:        [..., 4, 4] initial covariance (defaults to
                 params.p0 * I); lets incremental callers carry
                 covariance across calls.

    Returns (states [..., T, 4], covariances [..., T, 4, 4]).

    The measurement update is masked, not branched: ``K`` is scaled by
    the mask so no-fix steps reduce to pure propagation — the answer to
    the reference's callback-per-measurement architecture
    (``localization_gnss_process.cc``).
    """
    dev = pick_device(device, x0, imu)
    x = as_f32(x0, dev)
    imu = as_f32(imu, dev)
    gnss = as_f32(gnss, dev)
    mask = as_f32(gnss_mask, dev)
    q, r, h = _ekf_consts(params, dev)
    if p0 is None:
        p = (torch.eye(4, dtype=_F32, device=dev) * params.p0).expand(
            *x.shape[:-1], 4, 4)
    else:
        p = as_f32(p0, dev)
    xs, ps = [], []
    with precision("float32"):
        for t in range(imu.shape[0]):
            x, p = _ekf_step(x, p, imu[t], gnss[t], mask[t], q, r, h,
                             params.dt)
            xs.append(x)
            ps.append(p)
    return torch.stack(xs, -2), torch.stack(ps, -3)


def dead_reckon(x0, imu, dt: float = 0.01, device=None):
    """IMU-only propagation (the no-fusion baseline the EKF must beat)."""
    dev = pick_device(device, x0, imu)
    x = as_f32(x0, dev)
    imu = as_f32(imu, dev)
    xs = []
    for t in range(imu.shape[0]):
        x, _ = _propagate(x, imu[t], dt)
        xs.append(x)
    return torch.stack(xs, -2)


def rtk_interpolate(imu_t, imu_pose, fix_t, device=None) -> torch.Tensor:
    """Interpolate buffered IMU poses to GNSS fix timestamps — batched.

    The reference walks its IMU list per fix
    (``rtk_localization.cc`` ``FindMatchingIMU`` + interpolation); here
    every fix is resolved in one vectorized gather:
    ``searchsorted`` locates the bracketing samples, linear weights
    blend them. Query times outside the buffer clamp to the ends (the
    reference's nearest-message fallback).

    Args: imu_t [N] ascending timestamps; imu_pose [N, D]; fix_t [M].
    Returns [M, D].
    """
    dev = pick_device(device, imu_t, imu_pose, fix_t)
    imu_t = as_f32(imu_t, dev)
    imu_pose = as_f32(imu_pose, dev)
    fix_t = as_f32(fix_t, dev)
    hi = torch.searchsorted(imu_t, fix_t).clamp(1, imu_t.shape[0] - 1)
    lo = hi - 1
    t0, t1 = imu_t[lo], imu_t[hi]
    w = torch.where(t1 > t0, (torch.minimum(torch.maximum(fix_t, t0), t1)
                              - t0) / torch.clamp_min(t1 - t0, 1e-9),
                    0.0)
    return imu_pose[lo] + w[:, None] * (imu_pose[hi] - imu_pose[lo])


class LocalizationComponent(Component):
    """imu (primary) + gnss (fused latest) → pose messages.

    The ``rtk_localization_component.cc`` role: per IMU message,
    propagate; when a newer GNSS fix has arrived since the last proc,
    run the masked EKF update. Incremental (one step per message) so it
    composes with the deterministic runtime's replay semantics. ``x``
    and ``P`` stay on ``device`` between messages.
    """

    def __init__(self, *, imu_channel: str = "imu",
                 gnss_channel: str = "gnss", out_channel: str = "pose",
                 x0=(0.0, 0.0, 0.0, 0.0),
                 params: EkfParams = EkfParams(), device="cuda"):
        super().__init__("localization", [imu_channel, gnss_channel])
        self.device = resolve_device(device)
        self.out_channel = out_channel
        self.params = params
        self._x = torch.tensor(x0, dtype=_F32).to(self.device)
        self._consts = _ekf_consts(params, self.device)
        # hold the consumed fix itself and compare with `is`: an id()
        # of a freed dict can be recycled for the next fix and would
        # silently drop a genuine update
        self._last_fix: Optional[Any] = None

    def on_init(self, ctx):
        self._write = ctx.writer(self.out_channel)
        self._p = torch.eye(4, dtype=_F32, device=self.device) \
            * self.params.p0

    def proc(self, imu_msg: Any, gnss_msg: Any = None) -> None:
        fresh = gnss_msg is not None and gnss_msg is not self._last_fix
        if fresh:
            self._last_fix = gnss_msg
            z = gnss_msg["pos"]
        else:
            z = (0.0, 0.0)
        # one host-to-device copy a message: (yaw_rate, accel, z, mask)
        msg = torch.tensor([imu_msg["yaw_rate"], imu_msg["accel"],
                            float(z[0]), float(z[1]),
                            1.0 if fresh else 0.0], dtype=_F32)
        msg = msg.to(self.device)
        with precision("float32"):
            self._x, self._p = _ekf_step(self._x, self._p, msg[:2],
                                         msg[2:4], msg[4], *self._consts,
                                         self.params.dt)
        out = torch.cat([self._x, torch.diagonal(self._p)]).cpu().numpy()
        self._write({"pos": out[:2], "yaw": float(out[2]),
                     "v": float(out[3]), "cov": out[4:]})
