"""Prediction-lite — constant-velocity free-move prediction.

The reference's prediction module consumes perception obstacles and
emits predicted trajectories; its simplest production predictor is the
free-move extrapolation (``modules/prediction/predictor/free_move/
free_move_predictor.cc`` — constant-velocity Kalman rollout over the
horizon, managed by ``predictor/predictor_manager.cc`` and fed to
planning as obstacle trajectories). Redesign: velocity estimation is
finite-difference over track history, and the horizon rollout for ALL
tracked obstacles is one vectorized broadcast — ``[K]`` obstacles ×
``[T]`` steps with static shapes, no per-obstacle host loop.

The planning handoff stays in Frenet: each predicted obstacle becomes a
*swept corridor* row ``(s0, s1, l0, l1)`` covering its box over the
whole horizon, directly consumable by
:func:`tosem_tpu_torch.models.planning.plan_path` (the role of the reference's
ST-graph obstacle mapping, ``modules/planning/tasks/deciders/
speed_bounds_decider/st_boundary_mapper.cc``, reduced to its static-
corridor essence).

The port's copy of ``tosem_tpu/models/prediction.py``: numpy on the
host, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from tosem_tpu_torch.dataflow.components import Component
from tosem_tpu_torch.models.planning import EMPTY_OBSTACLE, pad_obstacle_rows

__all__ = ["predict_rollout", "swept_obstacles", "TrackVelocityEstimator",
           "PredictionComponent"]


def predict_rollout(boxes: np.ndarray, vels: np.ndarray, *,
                    horizon: float = 5.0, dt: float = 0.5) -> np.ndarray:
    """Constant-velocity rollout: ``[K, 4]`` boxes + ``[K, 2]`` center
    velocities → ``[K, T, 4]`` predicted boxes at t = dt..horizon.
    One broadcasted op for every obstacle and step (the free-move
    predictor's per-obstacle Kalman loop, vectorized)."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    vels = np.asarray(vels, np.float32).reshape(-1, 2)
    t = np.arange(dt, horizon + 1e-6, dt, dtype=np.float32)      # [T]
    shift = t[None, :, None] * np.concatenate([vels, vels], axis=1)[
        :, None, :]                                              # [K,T,4]
    return boxes[:, None, :] + shift


def swept_obstacles(boxes: np.ndarray, vels: np.ndarray, *,
                    horizon: float = 5.0, dt: float = 0.5,
                    lane_half: float = 1.75,
                    max_k: int = 3) -> np.ndarray:
    """Swept Frenet corridor per obstacle: the union of its predicted
    boxes over the horizon as one static ``(s0, s1, l0, l1)`` row,
    padded with ``EMPTY_OBSTACLE`` to ``max_k`` (static shapes for the
    batched planner). Obstacles that never intersect the lane band or
    stay behind the ego are dropped."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    if boxes.shape[0] == 0:
        return np.asarray([EMPTY_OBSTACLE] * max_k, np.float32)
    roll = predict_rollout(boxes, vels, horizon=horizon, dt=dt)
    all_t = np.concatenate([boxes[:, None, :], roll], axis=1)    # [K,T+1,4]
    s0 = np.minimum(all_t[..., 0], all_t[..., 2]).min(axis=1)
    s1 = np.maximum(all_t[..., 0], all_t[..., 2]).max(axis=1)
    l0 = np.minimum(all_t[..., 1], all_t[..., 3]).min(axis=1)
    l1 = np.maximum(all_t[..., 1], all_t[..., 3]).max(axis=1)
    return np.asarray(pad_obstacle_rows(
        zip(s0, s1, l0, l1), lane_half=lane_half, max_k=max_k))


class TrackVelocityEstimator:
    """Finite-difference center velocity per track id — the velocity
    the reference gets from its tracker's Kalman state
    (``modules/perception/.../multi_object_tracker``); our greedy IoU
    tracker keeps boxes only, so prediction differentiates them."""

    def __init__(self, dt: float):
        if dt <= 0:
            raise ValueError("dt must be positive")
        self.dt = dt
        self._prev: Dict[int, np.ndarray] = {}

    @staticmethod
    def _center(box: np.ndarray) -> np.ndarray:
        b = np.asarray(box, np.float32)
        return np.array([(b[0] + b[2]) / 2.0, (b[1] + b[3]) / 2.0],
                        np.float32)

    def update(self, tracks: Sequence[dict]) -> np.ndarray:
        """``[{track_id, box, ...}]`` → ``[K, 2]`` velocities (zero for
        first-seen tracks). Retired ids are forgotten."""
        vels = np.zeros((len(tracks), 2), np.float32)
        seen: Dict[int, np.ndarray] = {}
        for i, t in enumerate(tracks):
            c = self._center(np.asarray(t["box"], np.float32))
            tid = int(t["track_id"])
            prev = self._prev.get(tid)
            if prev is not None:
                vels[i] = (c - prev) / self.dt
            seen[tid] = c
        self._prev = seen
        return vels


class PredictionComponent(Component):
    """tracks → predicted swept obstacles (planner-ready rows).

    The ``predictor_manager`` role on the component runtime: subscribes
    to the tracker output, estimates velocities, publishes
    ``{"obstacles": [max_k, 4], "velocities": [K, 2]}``.
    """

    def __init__(self, *, in_channel: str = "tracks",
                 out_channel: str = "predicted_obstacles",
                 frame_dt: float = 0.1, horizon: float = 5.0,
                 dt: float = 0.5, lane_half: float = 1.75,
                 max_k: int = 3):
        super().__init__("prediction", [in_channel])
        self.out_channel = out_channel
        self.estimator = TrackVelocityEstimator(frame_dt)
        self.horizon, self.dt = horizon, dt
        self.lane_half, self.max_k = lane_half, max_k

    def on_init(self, ctx):
        self._write = ctx.writer(self.out_channel)

    def proc(self, tracks, *fused):
        boxes = np.asarray([t["box"] for t in tracks],
                           np.float32).reshape(-1, 4)
        vels = self.estimator.update(tracks)
        obstacles = swept_obstacles(
            boxes, vels, horizon=self.horizon, dt=self.dt,
            lane_half=self.lane_half, max_k=self.max_k)
        self._write({"obstacles": obstacles, "velocities": vels})
