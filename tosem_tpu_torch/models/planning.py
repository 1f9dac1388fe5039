"""Planning-lite — piecewise-jerk path & speed optimization as batched
linear algebra.

The reference's on-road planner optimizes a lateral path l(s) and a
speed profile s(t) as QPs over discretized stations
(``modules/planning/tasks/optimizers/piecewise_jerk_path/
piecewise_jerk_path_optimizer.cc``, ``piecewise_jerk_speed/``, backed by
``modules/planning/math/piecewise_jerk/`` + OSQP). Same state
formulation as the JAX package's ``tosem_tpu/models/planning.py`` —
decision variables are the SECOND derivative sequence, the profile is
its double integration from the anchored initial state — solved by a
fixed-iteration **penalty method**: each iteration is one dense
symmetric solve. The candidate corridors (pass-left/pass-right per
obstacle, the DP part of the reference's DP+QP split) are ONE batched
solve, ``[2^K, n-2, n-2]``, each corridor's active walls a batched mask,
and the cheapest wins by ``torch.argmin`` (the first minimum, as
``jnp.argmin``). An infeasible corridor costs ``inf``.

Everything is Frenet-frame: stations ``s`` along the reference line,
lateral offset ``l`` (left positive). Obstacles are static corridor
constraints ``(s0, s1, l0, l1)``; pad with ``EMPTY_OBSTACLE`` rows to
keep shapes static.

The solvers run in fp32 with TF32 off (``ops.common.precision``) on the
device of their tensor inputs, or ``device`` (default ``"cuda"``) when
the inputs are numbers or numpy. Divisions by a step size divide by a
device tensor: a CUDA division by a Python scalar multiplies by its
reciprocal, which the CPU does not. Solves use
``torch.linalg.solve_ex``, which does not wait on the device.
"""
from __future__ import annotations

import functools
import itertools
from typing import Tuple

import numpy as np
import torch

from tosem_tpu_torch.ops.common import as_f32, pick_device, precision

__all__ = ["EMPTY_OBSTACLE", "solve_corridor", "corridor_candidates",
           "plan_path", "plan_speed", "live_obstacle_rows",
           "blocks_lane", "pad_obstacle_rows", "obstacles_from_tracks"]

EMPTY_OBSTACLE = (-1.0, -2.0, 0.0, 0.0)   # s0 > s1 → overlaps nothing

_F32 = torch.float32


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` over the last axis of a batch of vectors ``v``."""
    return (m @ v.unsqueeze(-1)).squeeze(-1)


def _solve(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(h, b.unsqueeze(-1))[0].squeeze(-1)


def _penalty_solve(h_base, b_base, penalty_fn, n_iter: int):
    """Fixed-iteration penalty method: each step solves the base QP plus
    the quadratic walls ``penalty_fn`` activates for the previous
    iterate. The one solver behind both the path and speed optimizers
    (the OSQP role, recast as n_iter dense solves). Returns the decision
    vars and what ``penalty_fn`` reported of the last iteration's walls
    (None when ``n_iter`` is 0)."""
    a = _solve(h_base, b_base)
    walls = None
    for _ in range(n_iter):
        dh, db, walls = penalty_fn(a)
        a = _solve(h_base + dh, b_base + db)
    return a, walls


@functools.lru_cache(maxsize=64)
def _maps(n: int, h: float, device: str):
    """(A [n, n-2], V [n-1, n-2], D [n-3, n-2]) on ``device``, made once.

    x = X0 + A a  with decision vars a = x'' at the first n-2 knots:
    x'_{k+1} = x'_k + a_k h, x_{k+1} = x_k + x'_k h + a_k h²/2. A maps a
    to positions (minus the init-state affine part), V to knot
    velocities x'_1..x'_{n-1} (both made in float64 and rounded to fp32,
    as the JAX package's), D = diff(I)/h to the jerk."""
    m = n - 2
    vmap_ = np.tril(np.ones((n - 1, n - 1)))[:, :m] * h
    a_map = np.zeros((n, m))
    for k in range(1, n):
        for j in range(min(k, m)):
            # a_j contributes h²/2 at its own step plus h² per later step
            a_map[k, j] = (h * h / 2.0) + (k - 1 - j) * h * h
    dev = torch.device(device)
    jerk = torch.from_numpy(np.diff(np.eye(m), axis=0).astype(np.float32))
    return (torch.from_numpy(a_map.astype(np.float32)).to(dev),
            torch.from_numpy(vmap_.astype(np.float32)).to(dev),
            jerk.to(dev) / torch.full((), h, dtype=_F32, device=dev))


def _scalar(v, device) -> torch.Tensor:
    return torch.full((), float(v), dtype=_F32, device=device)


def _walls(x, lower, upper):
    """The penalty method's walls at profile ``x`` (``x < lower``,
    ``x > upper``: the decision the JAX package's ``planning.py:106-107``
    makes every iteration) as ``[..., 2, n]`` bool, and the margin that
    decides them, the least ``|x - bound|`` over both bounds."""
    walls = torch.stack([x < lower, x > upper], -2)
    margin = torch.minimum((x - lower).abs(), (x - upper).abs()).amin(-1)
    return walls, margin


def solve_corridor(lower, upper, *, ds: float,
                   init: Tuple[float, float],
                   w_ref: float = 0.2, w_d1: float = 0.5,
                   w_d2: float = 4.0, w_d3: float = 10.0,
                   n_iter: int = 8, device=None, detail: bool = False):
    """Smoothest profile inside [lower, upper] with anchored start.

    ``lower``/``upper`` are ``[n]`` or a batch ``[B, n]`` of corridors,
    solved together. Returns (profile, cost) of the same batch shape.
    Decision vars: the curvature sequence a = l'' (the piecewise-jerk
    state form); l is its double integration from ``init`` — the start
    constraints are exact by construction. Penalty iterations activate
    quadratic walls on the bounds the previous iterate violated.
    ``cost`` adds a large violation term, and ``inf`` where a corridor
    is infeasible (lower > upper anywhere), so it loses any argmin over
    candidates. ``detail=True`` adds the last iteration's walls
    ``[..., 2, n]`` (below ``lower``, above ``upper``, at the iterate
    before the last solve) and their margin, the least ``|l - bound|``
    there (``None`` for both when ``n_iter`` is 0).
    """
    dev = pick_device(device, lower, upper)
    lower = as_f32(lower, dev)
    upper = as_f32(upper, dev)
    with precision("float32"):
        n = lower.shape[-1]
        m = n - 2
        A, V, d3 = _maps(n, float(ds), str(dev))
        l0, dl0 = _scalar(init[0], dev), _scalar(init[1], dev)
        base = l0 + dl0 * ds * torch.arange(n, dtype=_F32, device=dev)
        mid = 0.5 * (lower + upper)
        eye = torch.eye(m, dtype=_F32, device=dev)
        # objective: w_ref ||base + A a - mid||² + w_d1 ||dl0 + V a||²
        #          + w_d2 ||a||² + w_d3 ||D a||²
        h_base = ((w_ref * A.T) @ A + (w_d1 * V.T) @ V + w_d2 * eye
                  + (w_d3 * d3.T) @ d3 + 1e-6 * eye)
        b_base = _mv(w_ref * A.T, mid - base) - _mv(
            w_d1 * V.T, dl0.expand(n - 1))
        w_pen = 1e4
        pen_at = w_pen * A.T

        def penalty(a):
            x = base + _mv(A, a)
            viol_lo = (x < lower).to(_F32)
            viol_hi = (x > upper).to(_F32)
            W = viol_lo + viol_hi
            target = viol_lo * lower + viol_hi * upper
            return (pen_at @ (W[..., :, None] * A),
                    _mv(pen_at, W * (target - base)),
                    _walls(x, lower, upper) if detail else None)

        a, walls = _penalty_solve(h_base, b_base, penalty, n_iter)
        x = base + _mv(A, a)
        viol = (torch.clamp_min(lower - x, 0.0)
                + torch.clamp_min(x - upper, 0.0))
        infeasible = (lower > upper).any(-1)
        cost = (w_ref * ((x - mid) ** 2).sum(-1)
                + w_d1 * ((dl0 + _mv(V, a)) ** 2).sum(-1)
                + w_d2 * (a ** 2).sum(-1)
                + w_d3 * (_mv(d3, a) ** 2).sum(-1)
                + 1e4 * (viol ** 2).sum(-1)
                + torch.where(infeasible, torch.inf, 0.0))
    if detail:
        return (x, cost) + (walls or (None, None))
    return x, cost


def corridor_candidates(n: int, ds: float, lane_half: float, obstacles,
                        device=None):
    """All pass-side assignments → batched (lower, upper) corridors.

    ``obstacles``: [K, 4] rows (s0, s1, l0, l1); EMPTY_OBSTACLE rows are
    inert. 2^K candidates (the DP decision per obstacle: pass left of it
    or right of it) as ``[2^K, n]`` bounds, one tensor op — the branch
    enumeration the reference does with dynamic programming over a road
    graph (``tasks/optimizers/road_graph/``).
    """
    dev = pick_device(device, obstacles)
    obstacles = as_f32(obstacles, dev)
    K = obstacles.shape[0]
    s = torch.arange(n, dtype=_F32, device=dev) * ds
    sides = torch.tensor(list(itertools.product((0, 1), repeat=K)),
                         dtype=_F32).to(dev)                # [2^K, K] 1=left
    s0, s1, l0, l1 = obstacles.unbind(1)
    overlap = ((s[None, :] >= s0[:, None])
               & (s[None, :] <= s1[:, None]))[None]     # [1, K, n]
    # pass left of an obstacle → stay above its top edge l1;
    # pass right → stay below its bottom edge l0
    side = sides[:, :, None]
    lo = torch.where(overlap & (side > 0.5), l1[None, :, None], -lane_half)
    hi = torch.where(overlap & (side < 0.5), l0[None, :, None], lane_half)
    return lo.amax(1), hi.amin(1)


def plan_path(obstacles, *, n: int = 64, ds: float = 1.0,
              lane_half: float = 1.75,
              init: Tuple[float, float] = (0.0, 0.0), device=None,
              detail: bool = False):
    """Best smooth lateral path around static obstacles.

    Returns (l_profile [n], cost, candidate_index) as tensors. All 2^K
    pass-side corridors are solved IN ONE BATCH (:func:`solve_corridor`
    over ``[2^K, n]`` bounds) and the cheapest wins (the first minimum).
    ``detail=True`` adds a dict with every candidate's cost, the chosen
    corridor's bounds, its last iteration's ``walls`` and their
    ``wall_margin`` (:func:`solve_corridor`), ``settled`` (the walls at
    the final profile are the last iteration's: the penalty method
    reached its fixed point; where it did not, two fp32 runs can part
    by metres) and ``cost_margin``: the cheapest differing corridor's
    cost less the chosen one's (``inf`` if none differs), the margin
    that decided the argmin.
    """
    dev = pick_device(device, obstacles)
    lowers, uppers = corridor_candidates(n, ds, lane_half, obstacles,
                                         device=dev)
    paths, costs, walls, margins = solve_corridor(
        lowers, uppers, ds=ds, init=init, device=dev, detail=True)
    best = torch.argmin(costs)
    out = (paths[best], costs[best], best)
    if detail:
        # the argmin's margin: the cheapest corridor that differs from
        # the chosen one (padding rows make exact duplicates) over it
        other = ((lowers != lowers[best]) | (uppers != uppers[best])).any(-1)
        rival = torch.where(other, costs, torch.inf).amin()
        x = paths[best]
        settled = (_walls(x, lowers[best], uppers[best])[0]
                   == walls[best]).all()
        return out + ({"costs": costs, "lower": lowers[best],
                       "upper": uppers[best], "walls": walls[best],
                       "wall_margin": margins[best], "settled": settled,
                       "cost_margin": rival - costs[best]},)
    return out


def plan_speed(stop_s, *, n_t: int = 40, dt: float = 0.25,
               v_init: float = 8.0, v_ref: float = 8.0,
               w_v: float = 1.0, w_a: float = 4.0, w_j: float = 4.0,
               n_iter: int = 10, device=None):
    """Speed profile s(t): track ``v_ref`` but stop before ``stop_s``.

    ``stop_s`` is a number, a 0-dim tensor or a batch ``[B]`` of fences
    (solved together). Returns (s_profile [..., n_t], cost [...]); cost
    carries a large fence/reverse violation term, so a physically
    impossible stop (fence inside braking distance) is detectable by the
    caller instead of silently violated — symmetric with
    :func:`solve_corridor`.

    The piecewise-jerk-speed QP in acceleration-state form: decision
    vars a_k, s and v by integration from (0, v_init). Cost = velocity
    tracking + accel + jerk; penalties keep s under the stop fence (the
    ST-graph upper envelope) and v non-negative.
    """
    dev = pick_device(device, stop_s)
    stop_s = as_f32(stop_s, dev)
    with precision("float32"):
        n = n_t
        A, V, d3 = _maps(n, float(dt), str(dev))
        m = n - 2
        vi, vr = _scalar(v_init, dev), _scalar(v_ref, dev)
        base = vi * dt * torch.arange(n, dtype=_F32, device=dev)
        eye = torch.eye(m, dtype=_F32, device=dev)
        h_base = ((w_v * V.T) @ V + w_a * eye + (w_j * d3.T) @ d3
                  + 1e-6 * eye)
        b_base = _mv(w_v * V.T, (vr - vi).expand(n - 1))
        upper = stop_s[..., None].expand(*stop_s.shape, n)
        w_pen = 1e4
        pen_at, pen_vt = w_pen * A.T, w_pen * V.T

        def penalty(a):
            sprof = base + _mv(A, a)
            v = vi + _mv(V, a)
            viol_hi = (sprof > upper).to(_F32)
            viol_v = (v < 0.0).to(_F32)
            return (pen_at @ (viol_hi[..., :, None] * A)
                    + pen_vt @ (viol_v[..., :, None] * V),
                    _mv(pen_at, viol_hi * (upper - base))
                    + _mv(pen_vt, viol_v * (-vi)), None)

        a, _ = _penalty_solve(h_base, b_base, penalty, n_iter)
        sprof = base + _mv(A, a)
        v = vi + _mv(V, a)
        cost = (w_v * ((v - vr) ** 2).sum(-1) + w_a * (a ** 2).sum(-1)
                + w_j * (_mv(d3, a) ** 2).sum(-1)
                + 1e4 * (torch.clamp_min(sprof - upper, 0.0) ** 2).sum(-1)
                + 1e4 * (torch.clamp_min(-v, 0.0) ** 2).sum(-1))
    return sprof, cost


def live_obstacle_rows(obstacles):
    """Non-padding, not-behind-ego rows of a ``[K, 4]`` obstacle array —
    the one liveness filter shared by the scenario rules, the planner's
    stop fence, and the emergency hard-fence path."""
    if isinstance(obstacles, torch.Tensor):
        obstacles = obstacles.cpu().numpy()
    return [(float(s0), float(s1), float(l0), float(l1))
            for s0, s1, l0, l1 in np.asarray(obstacles, np.float32)
            if s0 <= s1 and s1 >= 0.0]


def blocks_lane(row, *, lane_half: float = 1.75,
                min_pass_gap: float = 0.4) -> bool:
    """True when a Frenet row leaves less than ``min_pass_gap`` of
    lateral room on BOTH sides of the lane band — the full-lane-blocker
    predicate (shared so scenario and planner can never disagree about
    which obstacles block)."""
    _s0, _s1, l0, l1 = row
    room = max(l0 - (-lane_half), lane_half - l1)
    return room < min_pass_gap


def pad_obstacle_rows(rows, *, lane_half: float = 1.75,
                      max_k: int = 3) -> np.ndarray:
    """Candidate Frenet rows ``(s0, s1, l0, l1)`` → static ``[max_k, 4]``
    fp32 planner input (numpy: it is host bookkeeping): drop behind-ego
    (s1 < 0) and fully off-lane rows, keep the ``max_k`` nearest in s
    (tracker-insertion order must not decide survival), clip l to the
    lane band, pad with ``EMPTY_OBSTACLE``. The one select/clip/pad step
    shared by the perception handoff and the prediction sweep."""
    kept = []
    for s0, s1, l0, l1 in rows:
        s0, s1 = float(min(s0, s1)), float(max(s0, s1))
        l0, l1 = float(min(l0, l1)), float(max(l0, l1))
        if s1 < 0.0 or l0 > lane_half or l1 < -lane_half:
            continue
        kept.append((s0, s1, max(l0, -lane_half), min(l1, lane_half)))
    kept = sorted(kept)[:max_k]
    while len(kept) < max_k:
        kept.append(EMPTY_OBSTACLE)
    return np.asarray(kept, np.float32)


def obstacles_from_tracks(tracks, *, lane_half: float = 1.75,
                          max_k: int = 3) -> np.ndarray:
    """Frenet obstacle rows from perception tracks (x→s, y→l of the box
    centers/extents), padded with EMPTY_OBSTACLE to a static K — the
    perception→planning handoff (``modules/planning/common/obstacle.cc``
    role, minimal)."""
    rows = [(min(float(t.box[0]), float(t.box[2])),
             max(float(t.box[0]), float(t.box[2])),
             float(t.box[1]), float(t.box[3])) for t in tracks]
    return pad_obstacle_rows(rows, lane_half=lane_half, max_k=max_k)
