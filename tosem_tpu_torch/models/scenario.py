"""Scenario-lite — rule-based scenario selection over the planning loop.

The reference's planning scenario framework
(``modules/planning/scenarios/scenario_manager.cc``) classifies the
driving context each cycle, keeps a current scenario (lane-follow,
stop-sign, emergency, …) with hysteresis, and each scenario's stages
parameterize the same underlying optimizer tasks. The lite redesign
keeps exactly that contract minus the config plumbing: a
:class:`ScenarioManager` with three scenarios —

- ``LANE_FOLLOW``   — clear road: cruise at the route speed,
- ``OBSTACLE_AVOID``— obstacles inside the horizon: corridor planning
  at reduced speed,
- ``EMERGENCY_STOP``— a full-lane blocker closer than the braking
  distance: hard fence, target speed 0

— selected by rules over the predicted obstacles + ego speed, with
dwell-based hysteresis (de-escalation waits ``min_dwell`` frames;
ESCALATION to emergency is immediate — the asymmetry is the safety
contract). The :class:`ScenarioComponent` sits between prediction and
planning on the runtime and rewrites the planning request (the stage →
task-parameter role); the planner itself is unchanged — scenarios
parameterize, never reimplement, the optimizers.

The port's copy of ``tosem_tpu/models/scenario.py``: host rules over
numpy rows, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from tosem_tpu_torch.dataflow.components import Component

__all__ = ["LANE_FOLLOW", "OBSTACLE_AVOID", "EMERGENCY_STOP",
           "ScenarioManager", "ScenarioComponent"]

LANE_FOLLOW = "LANE_FOLLOW"
OBSTACLE_AVOID = "OBSTACLE_AVOID"
EMERGENCY_STOP = "EMERGENCY_STOP"

#: severity order: de-escalation is dwell-gated, escalation immediate
_SEVERITY = {LANE_FOLLOW: 0, OBSTACLE_AVOID: 1, EMERGENCY_STOP: 2}


@dataclass(frozen=True)
class _Params:
    """Per-scenario task parameters (the stage config role)."""
    v_ref: float
    hard_fence: bool = False


class ScenarioManager:
    """Per-cycle scenario classification with dwell hysteresis."""

    def __init__(self, *, cruise_v: float = 8.0, avoid_v: float = 5.0,
                 lane_half: float = 1.75, min_pass_gap: float = 0.4,
                 a_brake: float = 3.0, margin_m: float = 5.0,
                 min_dwell: int = 3):
        self.cruise_v, self.avoid_v = cruise_v, avoid_v
        self.lane_half, self.min_pass_gap = lane_half, min_pass_gap
        self.a_brake, self.margin_m = a_brake, margin_m
        self.min_dwell = min_dwell
        self.current = LANE_FOLLOW
        self._pending: Optional[str] = None
        self._dwell = 0

    # -- rules ---------------------------------------------------------

    def _classify(self, obstacles: np.ndarray, ego_v: float) -> str:
        """Raw per-cycle context (no hysteresis)."""
        from tosem_tpu_torch.models.planning import (blocks_lane,
                                               live_obstacle_rows)
        live = live_obstacle_rows(obstacles)
        if not live:
            return LANE_FOLLOW
        brake_dist = ego_v * ego_v / (2.0 * self.a_brake) + self.margin_m
        for row in live:
            if blocks_lane(row, lane_half=self.lane_half,
                           min_pass_gap=self.min_pass_gap) \
                    and row[0] <= brake_dist:
                return EMERGENCY_STOP
        return OBSTACLE_AVOID

    def select(self, obstacles, ego_v: float) -> str:
        """Hysteresis step: escalation switches immediately; a calmer
        scenario must persist ``min_dwell`` consecutive cycles before
        the manager de-escalates (the scenario-switch debounce)."""
        raw = self._classify(np.asarray(obstacles, np.float32), ego_v)
        if _SEVERITY[raw] > _SEVERITY[self.current]:
            self.current = raw
            self._pending, self._dwell = None, 0
        elif raw != self.current:
            # de-escalation needs min_dwell consecutive cycles of the
            # SAME calmer scenario — mixed evidence (avoid, avoid,
            # lane-follow) must not let emergency skip straight to
            # cruise
            if raw != self._pending:
                self._pending, self._dwell = raw, 1
            else:
                self._dwell += 1
            if self._dwell >= self.min_dwell:
                self.current = raw
                self._pending, self._dwell = None, 0
        else:
            self._pending, self._dwell = None, 0
        return self.current

    def params(self, scenario: Optional[str] = None) -> _Params:
        s = scenario or self.current
        if s == EMERGENCY_STOP:
            return _Params(v_ref=0.0, hard_fence=True)
        if s == OBSTACLE_AVOID:
            return _Params(v_ref=self.avoid_v)
        return _Params(v_ref=self.cruise_v)


class ScenarioComponent(Component):
    """predicted obstacles (+ ego state) → parameterized planning
    request: the scenario_manager's dispatch seat on the runtime."""

    def __init__(self, manager: Optional[ScenarioManager] = None, *,
                 in_channel: str = "predicted_obstacles",
                 ego_channel: str = "ego",
                 out_channel: str = "planning_request"):
        super().__init__("scenario", [in_channel, ego_channel])
        self.manager = manager or ScenarioManager()
        self.out_channel = out_channel

    def on_init(self, ctx):
        self._write = ctx.writer(self.out_channel)

    def proc(self, pred, ego, *fused):
        ego_v = float(ego["v"]) if ego else self.manager.cruise_v
        scenario = self.manager.select(pred["obstacles"], ego_v)
        p = self.manager.params(scenario)
        # pass the prediction message THROUGH (velocities etc. stay
        # available downstream); the scenario layer only adds fields
        self._write({**pred, "scenario": scenario, "v_ref": p.v_ref,
                     "hard_fence": p.hard_fence})
